"""``mv3d::bn_relu`` (``mv3d_tpu_torch/ops/bn_relu.py``), eval-mode
BatchNorm + ReLU in one pass, on the CPU: the operator equals the
composition the model ran before it (cast to f32, BatchNorm on the running
statistics, ReLU, cast back) bit for bit, with the layouts the served
program hands it (channels-last trunks and ROI towers, the split stem's
cropped view, NCHW, H x W not a multiple of 8, the dense layers' 2-D
input) in bf16 and f32; the fake implementation gives the CPU one's
shape, dtype and strides; the kernel's view of the input (rows, their
stride, the channel's extent) addresses the same elements as the plain
version; its gradient is the composition's, so an eval-mode model stays
differentiable; ``models.backbone.bn_relu`` takes the operator in eval
mode only, whatever the grad mode, and leaves train mode as it was. The
kernel itself runs on the card (tests/test_torch_cuda.py)."""

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from mv3d_tpu_torch.models import backbone
from mv3d_tpu_torch.ops import bn_relu as fused

torch.set_num_threads(2)


def _bn(c, seed=0):
    """An eval-mode BatchNorm with drawn statistics and affine terms."""
    g = torch.Generator().manual_seed(seed)
    bn = backbone.BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) * 2 - 0.5)
        bn.bias.copy_(torch.randn(c, generator=g))
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) * 3 + 0.01)
    return bn.eval()


def _x(shape, dtype, seed=1, channels_last=False, crop=0):
    """Drawn (N, C, ...) input; ``crop`` cuts the last dim to a view."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 3).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return x[..., :crop] if crop else x


# name -> (shape, channels-last, crop): what the served program hands
# bn_relu (tests/test_torch_frozen.py counts its sites)
CASES = {
    "trunk nhwc": ((2, 64, 10, 6), True, 0),
    "split stem cropped nhwc": ((2, 64, 10, 8), True, 6),
    "roi tower nhwc": ((5, 24, 3, 3), True, 0),
    "nchw hw%8": ((2, 16, 4, 6), False, 0),
    "nchw odd hw": ((2, 12, 7, 9), False, 0),
    "nchw cropped": ((2, 16, 5, 11), False, 9),
    "dense 2-d": ((30, 40), False, 0),
    "odd channels nhwc": ((3, 5, 4, 4), True, 0),
}
DTYPES = [torch.bfloat16, torch.float32]


def _composition(bn, x):
    """The model's eval-mode epilogue before the operator."""
    return F.relu(bn(x.to(torch.float32))).to(x.dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_operator_equals_the_composition(case, dtype):
    shape, cl, crop = CASES[case]
    bn = _bn(shape[1])
    x = _x(shape, dtype, channels_last=cl, crop=crop)
    want = _composition(bn, x)
    got = backbone.bn_relu(bn, x, dtype)
    direct = fused.bn_relu(x, bn.weight, bn.bias, bn.running_mean,
                           bn.running_var, bn.eps)
    for out in (got, direct):
        assert out.dtype == dtype and out.stride() == want.stride()
        assert torch.equal(out, want), case
    assert (want > 0).any() and (want == 0).any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_fake_matches_the_cpu_implementation(case, dtype):
    shape, cl, crop = CASES[case]
    bn = _bn(shape[1])
    x = _x(shape, dtype, channels_last=cl, crop=crop)
    args = (x, bn.weight.detach(), bn.bias.detach(), bn.running_mean,
            bn.running_var)
    want = torch.ops.mv3d.bn_relu.default(*args, bn.eps)
    with FakeTensorMode() as mode:
        fake = torch.ops.mv3d.bn_relu.default(
            *(mode.from_tensor(t) for t in args), bn.eps)
    assert (fake.shape, fake.dtype, fake.stride()) == (
        want.shape, want.dtype, want.stride())


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_layout_addresses_the_plain_elements(case):
    """What the kernel computes, element by element, from the rows, their
    stride and the channel's extent that ``layout`` reads off the strides,
    written into the output's memory in order: the plain version's output
    there (f32; the kernel's FMA may round the last bit otherwise)."""
    shape, cl, crop = CASES[case]
    bn = _bn(shape[1])
    x = _x(shape, torch.float32, channels_last=cl, crop=crop)
    out = torch.empty_like(x)
    row_len, ld, inner = fused.layout(x, out)
    total = x.numel()
    rows = torch.as_strided(x, (total // row_len, row_len), (ld, 1),
                            x.storage_offset())
    invstd = 1.0 / torch.sqrt(bn.running_var + bn.eps)
    scale = (invstd * bn.weight).detach()
    shift = (bn.bias - bn.running_mean * scale).detach()
    c = (torch.arange(total) // inner) % shape[1]
    y = torch.relu(rows.reshape(-1).double() * scale[c].double()
                   + shift[c].double())
    plain = fused.bn_relu_plain(x, bn.weight, bn.bias, bn.running_mean,
                                bn.running_var, bn.eps)
    assert plain.stride() == out.stride()
    memory = torch.as_strided(plain, (total,), (1,), plain.storage_offset())
    torch.testing.assert_close(memory.double(), y, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case, want", [
    ("trunk nhwc", (2 * 10 * 6 * 64, 2 * 10 * 6 * 64, 1,
                    fused.EIGHT_CHANNELS)),
    ("split stem cropped nhwc", (6 * 64, 8 * 64, 1, fused.EIGHT_CHANNELS)),
    ("roi tower nhwc", (5 * 9 * 24, 5 * 9 * 24, 1, fused.EIGHT_CHANNELS)),
    ("nchw hw%8", (2 * 16 * 24, 2 * 16 * 24, 24, fused.SCALAR)),
    ("nchw odd hw", (2 * 12 * 63, 2 * 12 * 63, 63, fused.SCALAR)),
    ("nchw cropped", (9, 11, 45, fused.SCALAR)),
    ("dense 2-d", (1200, 1200, 1, fused.EIGHT_CHANNELS)),
    ("odd channels nhwc", (3 * 16 * 5, 3 * 16 * 5, 1, fused.SCALAR)),
])
def test_layout_and_mode_follow_the_strides(case, want):
    shape, cl, crop = CASES[case]
    x = _x(shape, torch.bfloat16, channels_last=cl, crop=crop)
    row_len, ld, inner = fused.layout(x, torch.empty_like(x))
    assert (row_len, ld, inner, fused.mode(x, row_len, ld, inner)) == want


def test_layout_refuses_more_than_one_row_stride():
    x = torch.zeros(2, 8, 6, 10)[:, :, :4, :5]     # two cuts: two strides
    with pytest.raises(ValueError, match="one stride"):
        fused.layout(x, torch.empty_like(x))


def test_operator_checks_its_inputs():
    bn = _bn(8)
    x = torch.zeros(2, 8, 4, 4)
    with pytest.raises(TypeError):
        fused.bn_relu(x.half(), bn.weight, bn.bias, bn.running_mean,
                      bn.running_var, bn.eps)
    with pytest.raises(ValueError):
        fused.bn_relu(x, bn.weight[:4], bn.bias, bn.running_mean,
                      bn.running_var, bn.eps)
    with pytest.raises(ValueError, match="CUDA"):
        fused.bn_relu_kernel(x, bn.weight, bn.bias, bn.running_mean,
                             bn.running_var, bn.eps)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_gradient_equals_the_composition(case, dtype):
    """Backpropagation through the operator gives the input, weight and
    bias the gradients autograd takes through the plain composition, in
    the input's dtype for the input; the weight's and bias's sums over
    the batch within f32 summation order of the largest of them."""
    shape, cl, crop = CASES[case]
    bn = _bn(shape[1])
    x = _x(shape, dtype, channels_last=cl, crop=crop)
    grad = _x(tuple(x.shape), dtype, seed=2)
    grads = []
    for fn in (fused.bn_relu, fused.bn_relu_plain):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, bn.weight, bn.bias)]
        out = fn(*leaves, bn.running_mean, bn.running_var, bn.eps)
        grads.append(torch.autograd.grad(out, leaves, grad))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(
            got, want, rtol=1e-5,
            atol=1e-5 * max(1.0, float(want.abs().max())))
    assert grads[1][0].abs().sum() > 0 and (grads[1][0] == 0).any()


def test_gradient_refuses_running_statistics_that_need_grad():
    bn = _bn(8)
    x = _x((2, 8, 4, 4), torch.float32)
    with pytest.raises(RuntimeError, match="running statistics"):
        fused.bn_relu(x, bn.weight, bn.bias,
                      bn.running_mean.clone().requires_grad_(),
                      bn.running_var, bn.eps)


def test_eval_model_stays_differentiable():
    """An eval-mode ``ConvBnRelu`` (frozen statistics, as in fine-tuning
    or attribution) gives its input and every parameter a gradient, as
    it did before the operator."""
    m = backbone.ConvBnRelu(8, 16).eval()
    with torch.no_grad():
        m.BatchNorm_0.load_state_dict(_bn(16).state_dict())
    x = _x((2, 8, 6, 6), torch.float32, channels_last=True)
    x.requires_grad_()
    m(x).float().sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    for name, p in m.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_train_mode_keeps_the_batch_statistics_path(dtype, monkeypatch):
    """Train mode normalizes with the batch mean and biased variance and
    moves the running statistics by 0.1 of them, as before the operator;
    nothing of it goes through ``mv3d::bn_relu``."""
    bn = _bn(16).train()
    ref = _bn(16).train()
    x = _x((4, 16, 5, 7), dtype, channels_last=True)
    calls = []
    monkeypatch.setattr(backbone, "fused_bn_relu",
                        lambda *a: calls.append(a) or fused.bn_relu(*a))
    got = backbone.bn_relu(bn, x, dtype)
    want = _composition(ref, x)
    assert not calls
    assert torch.equal(got, want) and got.dtype == dtype
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(bn, name), getattr(ref, name)), name
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
    start = _bn(16)
    torch.testing.assert_close(bn.running_mean,
                               start.running_mean * 0.9 + mean * 0.1)
    torch.testing.assert_close(bn.running_var,
                               start.running_var * 0.9 + var * 0.1)
    batch = (xf - mean[:, None, None]) * torch.rsqrt(var[:, None, None]
                                                     + bn.eps)
    torch.testing.assert_close(
        got.float(), F.relu(batch * bn.weight[:, None, None]
                            + bn.bias[:, None, None]).to(dtype).float(),
        rtol=1e-2 if dtype == torch.bfloat16 else 1e-5, atol=1e-2
        if dtype == torch.bfloat16 else 1e-5)


def test_export_holds_the_operator_with_parameters_that_need_grad():
    """A module exported in eval mode with grad on and parameters that
    require grad, as ``export_serving`` traces, holds ``mv3d.bn_relu`` and
    no BatchNorm; the program answers as the module does."""
    m = backbone.ConvBnRelu(8, 16).eval()
    with torch.no_grad():
        m.BatchNorm_0.load_state_dict(_bn(16).state_dict())
    assert all(p.requires_grad for p in m.parameters())
    x = _x((2, 8, 10, 12), torch.float32, channels_last=True)
    program = torch.export.export(m, (x,), strict=False)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("mv3d.bn_relu.default") == 1
    assert not [t for t in targets if "batch_norm" in t]
    assert torch.equal(program.module()(x), m(x))
