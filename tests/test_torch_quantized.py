"""The port's int8 serving forward (``mv3d_tpu_torch.ops.quantized`` and
``model.quant="int8"``) against ``tests/test_quantized.py``'s contract and
the JAX package, on the CPU.

The JAX side runs eagerly (op by op), never under ``jit``: jitted XLA
folds the dequantization's scalar products differently and moves ~1/3 of
the int8 products' outputs by an f32 ulp (measured here: 488 of 1,536
for a 64 x 96 x 24 dense), where the eager ops and the port agree bit for
bit. Model-level comparisons feed both packages the same converted
weights (random BatchNorm statistics) in f32 compute.

Tolerances:
  * weight and activation quantization, ``int8_dense`` and ``int8_conv``
    (1x1, 3x3/1, 3x3/2 and 1x1/2 on odd and even sizes; flax's
    asymmetric SAME): bit-equal, int8 values, scales and outputs;
  * ``train=True``: bit-equal to the float model (it is the float
    program);
  * TopRPN, FusionHead and the detections in eval mode: the float inputs
    of an int8 layer differ between the packages in the last bits (two f32
    conv implementations), so an element on a rounding boundary moves by
    one int8 level, and run freely the moves compound with depth
    (measured on the tiny TopRPN: none in the first 7 int8 layers, then
    up to 20% of an activation's elements and 4 levels by the 25th, and
    score differences of 4e-2). So JAX's int8 activations and scales are
    recorded and replayed, in order, into the port's layers: where the
    port's own quantization of its input differs from JAX's, it is by one
    level at most and at most 1e-3 of the elements (counted); the outputs
    are then held to the float tolerances (tests/test_torch_models.py and
    tests/test_torch_options.py): rtol/atol 1e-4, and for detections the
    same mask, boxes3d within 1e-3 m and probs within 1e-4;
  * an int8 artifact against in-process int8 ``predict_from_points``, and
    an artifact of ``cli.export --set model.quant int8`` answered by
    ``cli.serve.make_server`` against its in-process call: bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from mv3d_tpu.models.mv3d_net import MV3DNet as JaxMV3DNet
from mv3d_tpu.models.nets import FusionHead as JaxFusionHead
from mv3d_tpu.ops import quantized as jq
from mv3d_tpu.ops import voxelize as jvox
from mv3d_tpu_torch import convert
from mv3d_tpu_torch.models.backbone import Linear, conv
from mv3d_tpu_torch.models.mv3d_net import MV3DNet
from mv3d_tpu_torch.models.nets import FusionHead
from mv3d_tpu_torch.ops import quantized as tq
from mv3d_tpu_torch.serving import export_serving, load_serving
from mv3d_tpu_torch.train.trainer import MV3D

from test_torch_config import to_port_config
from test_torch_models import randomize_bn

torch.set_num_threads(2)

CFG = dataclasses.replace(_tiny_config(), model=dataclasses.replace(
    _tiny_config().model, compute_dtype="float32"))
QCFG = dataclasses.replace(CFG, model=dataclasses.replace(CFG.model,
                                                          quant="int8"))
PCFG, PQCFG = to_port_config(CFG), to_port_config(QCFG)
THRESH = 0.05
TOL = dict(rtol=1e-4, atol=1e-4)


def _hwio(w_torch: np.ndarray) -> np.ndarray:
    """A torch (out, in, kh, kw) conv weight as flax's HWIO kernel."""
    return np.ascontiguousarray(w_torch.transpose(2, 3, 1, 0))


def test_quantize_weight_and_activation_match_jax():
    """Per-output-channel weight scales (one channel 100x the others, and
    an all-zero channel at the 1e-12 floor) and per-tensor activation
    scales: int8 values and scales bit-equal to the JAX functions."""
    rng = np.random.RandomState(2)
    w = rng.randn(6, 8, 5, 5).astype(np.float32)
    w[2] *= 100.0
    w[4] = 0.0
    for wt, wj in ((w, _hwio(w)), (w[:, :, 0, 0], w[:, :, 0, 0].T)):
        q, s = tq.quantize_weight(torch.from_numpy(wt))
        jqw, js = jq.quantize_weight(jnp.asarray(wj))
        assert q.dtype == torch.int8 and s.shape == (6,)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        want = np.asarray(jqw)
        want = want.transpose(3, 2, 0, 1) if want.ndim == 4 else want.T
        np.testing.assert_array_equal(q.numpy(), want)
    for x in (rng.rand(2, 12, 14, 16), rng.randn(40, 96) * 3,
              np.zeros((3, 4))):
        x = x.astype(np.float32)
        q, s = tq.quantize_activation(torch.from_numpy(x))
        jqx, js = jq.quantize_activation(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqx))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("rows,k,n", [(64, 96, 32), (5, 13, 7), (17, 8, 8)])
def test_int8_dense_matches_jax(rows, k, n):
    """``int8_dense`` and a ``Linear`` with ``quant="int8"`` in eval mode:
    bit-equal to JAX's ``int8_dense`` (f32 out), at shapes that need no
    padding and at rows <= 16 with K and N not multiples of 8."""
    rng = np.random.RandomState(rows)
    x = rng.randn(rows, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.1).astype(np.float32)
    want = np.asarray(jq.int8_dense(jnp.asarray(x), jnp.asarray(w),
                                    out_dtype=jnp.float32))
    got = tq.int8_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                        torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    layer = Linear(k, n, bias=False)
    layer.quant = "int8"
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.T))
        np.testing.assert_array_equal(
            layer.eval()(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("kernel,stride,hw", [
    (1, 1, (13, 14)), (3, 1, (13, 14)), (3, 2, (13, 14)), (3, 2, (12, 10)),
    (1, 2, (13, 14)), (3, 2, (1, 1))])
def test_int8_conv_matches_jax(kernel, stride, hw):
    """The port's conv layer (``conv(..., quant="int8")``: ``Conv2d``, or
    ``StridedConv2d`` for the strided 3x3 with flax's asymmetric SAME
    pads) in eval mode against JAX's ``int8_conv(padding="SAME")``, f32
    out: bit-equal."""
    rng = np.random.RandomState(kernel * 10 + stride)
    x = rng.rand(2, *hw, 16).astype(np.float32)
    w = (rng.randn(24, 16, kernel, kernel) * 0.1).astype(np.float32)
    want = np.asarray(jq.int8_conv(jnp.asarray(x), jnp.asarray(_hwio(w)),
                                   (stride, stride), out_dtype=jnp.float32))
    layer = conv(16, 24, kernel, stride, quant="int8").eval()
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_conv_rejects_int8_with_bias():
    with pytest.raises(ValueError, match="bias-free"):
        conv(4, 4, 3, quant="int8", bias=True)
    with pytest.raises(ValueError, match="int4"):
        conv(4, 4, 3, quant="int4")


@pytest.mark.parametrize("change", ["copy_", "optimizer", "data", "train"])
def test_int8_weight_is_quantized_once_until_it_changes(monkeypatch,
                                                         change):
    """An int8 layer in eval mode quantizes its weight at its first call
    and reuses it, ``eval()`` again included; an in-place copy, an
    optimizer step, new data (as ``.to()`` sets it) or a pass through
    train mode quantizes it again.
    Every output bit-equal to ``int8_conv`` on the weight of the time."""
    from mv3d_tpu_torch.models import backbone
    calls = []
    real = backbone.quantize_weight
    monkeypatch.setattr(backbone, "quantize_weight",
                        lambda w: calls.append(1) or real(w))
    torch.manual_seed(0)
    layer = conv(8, 16, 3, quant="int8").eval()
    x = torch.randn(2, 8, 9, 10)

    def want():
        return tq.int8_conv(x, layer.weight.detach(), 1, (1, 1, 1, 1),
                            torch.float32)

    with torch.no_grad():
        first = layer(x)
        assert torch.equal(layer.eval()(x), first)
        assert torch.equal(first, want())
    assert len(calls) == 1
    if change == "copy_":
        with torch.no_grad():
            layer.weight.copy_(layer.weight * 1.5 + 0.01)
    elif change == "optimizer":
        layer.weight.grad = torch.randn_like(layer.weight)
        torch.optim.SGD(layer.parameters(), lr=0.1).step()
    elif change == "data":
        layer.weight.data = layer.weight.data * 2.0
    else:
        layer.train().eval()
    with torch.inference_mode():
        again = layer(x)
        assert torch.equal(layer(x), again)
    assert len(calls) == 2
    assert torch.equal(again, want())
    assert torch.equal(again, first) == (change == "train")


@pytest.mark.parametrize("m,k,n", [(1, 3, 5), (16, 8, 8), (17, 13, 12),
                                   (40, 576, 64)])
def test_int_mm_pads_to_the_cuda_limits(monkeypatch, m, k, n):
    """Every ``torch._int_mm`` call gets more than 16 rows and K and N
    multiples of 8 (what CUDA accepts); the cropped result is the exact
    int32 product."""
    calls = []
    real = torch._int_mm

    def checked(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0
        assert b.shape[0] == a.shape[1] and b.shape[1] % 8 == 0
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", checked)
    g = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = tq.int_mm(a, b)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got, a.int() @ b.int().t())
    assert len(calls) == 1


@pytest.fixture(scope="module")
def variables():
    return randomize_bn(jax.jit(JaxMV3DNet(CFG).init_variables)(
        jax.random.PRNGKey(0)), seed=7)


def _port(cfg, variables):
    model = MV3DNet(cfg)
    convert.load_variables(model, variables)
    return model


def test_int8_keeps_the_state_dict_and_trains_the_float_program(variables):
    """``quant="int8"`` changes no parameter: the same keys and shapes, so
    one converted state_dict serves both; ``train=True`` (train mode) is
    the float program bit for bit, for the trunk and the fusion head."""
    fm, qm = _port(PCFG, variables), _port(PQCFG, variables)
    fsd, qsd = fm.state_dict(), qm.state_dict()
    assert list(fsd) == list(qsd)
    assert all(fsd[k].shape == qsd[k].shape for k in fsd)
    n_int8 = sum(getattr(m, "quant", "none") == "int8"
                 for m in qm.modules())
    assert n_int8 > 60
    rng = np.random.RandomState(4)
    top = torch.from_numpy(rng.rand(2, *CFG.top_shape).astype(np.float32))
    feats = {v: torch.from_numpy(rng.randn(6, 6, 6, 128).astype(np.float32))
             for v in ("top", "rgb")}
    for m in (fm, qm):
        m.train()
    of, oq = fm.top_rpn(top), qm.top_rpn(top)
    for k in ("scores", "deltas", "features"):
        assert torch.equal(of[k], oq[k]), k
    hf, hq = fm.fusion(feats), qm.fusion(feats)
    for k in ("scores", "deltas"):
        assert torch.equal(hf[k], hq[k]), k
    for a, b in zip(fm.buffers(), qm.buffers()):
        assert torch.equal(a, b)


class _Recorder:
    """Records JAX's int8 activations and their scales, in the order its
    layers quantize them."""

    def __init__(self, monkeypatch):
        self.records = []
        real = jq.quantize_activation

        def record(x):
            q, s = real(x)
            self.records.append((np.asarray(q), np.asarray(s)))
            return q, s

        monkeypatch.setattr(jq, "quantize_activation", record)


class _Replay:
    """Feeds JAX's recorded int8 activations and scales, in order, to the
    port's layers in place of their own, and counts the elements where
    the port's own quantization of its float input differs (asserting
    one level at most)."""

    def __init__(self, monkeypatch, records):
        self.records = list(records)
        self.moved = self.total = 0
        real = tq.quantize_activation

        def replay(x, group=None):
            own, _ = real(x, group)
            q, s = self.records.pop(0)
            q = torch.from_numpy(np.array(
                q.transpose(0, 3, 1, 2) if q.ndim == 4 else q))
            d = (own.int() - q.int()).abs()
            assert d.max() <= 1
            self.moved += int((d > 0).sum())
            self.total += d.numel()
            return q, torch.tensor(s)

        monkeypatch.setattr(tq, "quantize_activation", replay)

    def check(self):
        assert not self.records, f"{len(self.records)} records left"
        assert self.moved <= 1e-3 * self.total, (self.moved, self.total)


def test_top_rpn_int8_matches_jax(variables, monkeypatch):
    """The int8 TopRPN (eval) against flax's int8 TopRPN on the same
    weights, with JAX's int8 activations replayed: at most 1e-3 of the
    port's own activations off by one level, outputs within 1e-4."""
    rng = np.random.RandomState(3)
    top = (rng.rand(2, *CFG.top_shape) * (rng.rand(2, *CFG.top_shape) < 0.3)
           ).astype(np.float32)
    rec = _Recorder(monkeypatch)
    want = JaxMV3DNet(QCFG).top_rpn.apply(variables["top_view_rpn"],
                                          jnp.asarray(top), False)
    model = _port(PQCFG, variables).eval()
    replay = _Replay(monkeypatch, rec.records)
    with torch.no_grad():
        got = model.top_rpn(torch.from_numpy(top))
    replay.check()
    for k in ("scores", "deltas", "features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_fusion_head_int8_matches_jax(monkeypatch):
    """The int8 FusionHead (eval, default mode) against flax's, the same
    way. The flax module also runs ``fc_wo_rgb_1/2`` in eval mode (no
    output reads them; the port skips them), so their two records are
    dropped."""
    rng = np.random.RandomState(2)
    feats = {v: rng.rand(24, 6, 6, 128).astype(np.float32)
             for v in ("top", "rgb")}
    jhead = JaxFusionHead(cfg=QCFG, dtype=np.float32)
    variables = randomize_bn(jhead.init(jax.random.PRNGKey(3), feats), 4)
    rec = _Recorder(monkeypatch)
    want = jhead.apply(variables, feats, False)
    head = FusionHead(PQCFG, ["top", "rgb"])
    head.load_state_dict(convert.subnet_state_dict(variables))
    records = _drop_without_rgb(rec.records)
    replay = _Replay(monkeypatch, records)
    with torch.no_grad():
        got = head.eval()({v: torch.from_numpy(a) for v, a in feats.items()})
    replay.check()
    for k in ("scores", "probs", "deltas"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def _drop_without_rgb(records):
    """JAX's records without those of the default head's ``fc_wo_rgb_1/2``,
    which run before ``fc_all_1/2`` and the head's ``box_1/2``."""
    assert [q.shape[1:] for q, _ in records[-6:]] == \
        [(512,), (512,), (1024,), (512,), (512,), (256,)]
    return records[:-6] + records[-4:]


def _request(seed=1, b=2):
    rng = np.random.RandomState(seed)
    n, t = CFG.pipeline.max_points, CFG.top
    pts = np.stack([rng.uniform(t.x_min, t.x_max, (b, n)),
                    rng.uniform(t.y_min, t.y_max, (b, n)),
                    rng.uniform(t.z_min, t.z_max, (b, n)),
                    rng.uniform(0, 1, (b, n))], axis=-1).astype(np.float32)
    return (pts, np.array([n, n - 300], np.int32)[:b],
            rng.rand(b, *CFG.rgb_shape).astype(np.float32))


@pytest.fixture(scope="module")
def jax_int8(variables):
    """JAX's int8 detections of ``_request()`` (views and model eager) and
    its int8 activations, less ``fc_wo_rgb_1/2``'s."""
    pts, num, rgb = _request()
    top, occ = jvox.lidar_to_top_batch(jnp.asarray(pts), QCFG,
                                       jnp.asarray(num), return_occ=True)
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(mp)
        dets, _ = JaxMV3DNet(QCFG).forward_inference(
            variables, top, jnp.asarray(rgb), None, score_threshold=THRESH,
            top_occ=occ)
    return ([np.asarray(x) for x in (dets.boxes3d, dets.probs, dets.mask)],
            _drop_without_rgb(rec.records))


def _assert_dets_close(boxes, probs, mask, want):
    m = want[2]
    assert m.sum() >= 2, "too few live detections to compare"
    np.testing.assert_array_equal(mask, m)
    np.testing.assert_allclose(boxes[m], want[0][m], rtol=0, atol=1e-3)
    np.testing.assert_allclose(probs[m], want[1][m], rtol=0, atol=1e-4)


def test_int8_detections_match_jax(variables, jax_int8, monkeypatch):
    """``MV3D.predict_from_points`` of the int8 model against JAX's int8
    ``forward_inference`` (JAX's activations replayed); the float model's
    detections differ."""
    pts, num, rgb = _request()
    want, records = jax_int8
    model = MV3D(PQCFG, device="cpu", variables=variables)
    free = model.predict_from_points(pts, num, rgb, THRESH)
    replay = _Replay(monkeypatch, records)
    dets = model.predict_from_points(pts, num, rgb, THRESH)
    replay.check()
    _assert_dets_close(dets.boxes3d.numpy(), dets.probs.numpy(),
                       dets.mask.numpy(), want)
    flt = MV3D(PCFG, device="cpu", variables=variables
               ).predict_from_points(pts, num, rgb, THRESH)
    assert not torch.equal(flt.probs, free.probs)


def test_int8_model_quantizes_its_weights_at_the_first_request(
        variables, monkeypatch):
    """Requests after the first reuse every int8 layer's quantized weight
    (``predict_from_points`` puts the model in eval mode each time) and
    answer bit-equal to the first."""
    from mv3d_tpu_torch.models import backbone
    calls = []
    real = backbone.quantize_weight
    monkeypatch.setattr(backbone, "quantize_weight",
                        lambda w: calls.append(1) or real(w))
    model = MV3D(PQCFG, device="cpu", variables=variables)
    first = model.predict_from_points(*_request(), THRESH)
    n = len(calls)
    assert n >= 20
    again = model.predict_from_points(*_request(), THRESH)
    assert len(calls) == n
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_int8_artifact(variables, jax_int8, tmp_path, monkeypatch):
    """An int8 artifact is the float artifact with ``quant="int8"`` in its
    config: ``load_serving`` restores the int8 model, whose answers equal
    in-process int8 ``predict_from_points`` bit for bit, and JAX's int8
    detections with JAX's activations replayed."""
    model = MV3D(PQCFG, device="cpu", variables=variables)
    art = export_serving(model.get_variables(), PQCFG, str(tmp_path / "q"),
                         batch_size=2, score_threshold=THRESH)
    served = load_serving(art, device="cpu")
    assert served.cfg.model.quant == "int8"
    pts, num, rgb = _request()
    boxes, probs, mask = served(pts, num, rgb)
    want = model.predict_from_points(pts, num, rgb, THRESH)
    for g, w in zip((boxes, probs, mask), want):
        np.testing.assert_array_equal(g, w.numpy())
    replay = _Replay(monkeypatch, jax_int8[1])
    boxes, probs, mask = served(pts, num, rgb)
    replay.check()
    _assert_dets_close(boxes, probs, mask, jax_int8[0])


def test_cli_export_and_serve_int8(tmp_path):
    """``cli.export --set model.quant int8`` (as the JAX CLI takes it)
    writes an int8 artifact; ``cli.serve.make_server`` answers a request
    over HTTP bit-equal to the artifact's in-process call."""
    import io
    import json
    import threading
    from mv3d_tpu_torch.cli import export as cli_export
    from mv3d_tpu_torch.cli.serve import make_server
    from test_cli_mains import TINY_OVERRIDES
    from test_torch_serving import _npz, _post
    overrides = tmp_path / "tiny.json"
    overrides.write_text(json.dumps(TINY_OVERRIDES))
    art = cli_export.main([
        "--random-init", "--out", str(tmp_path / "art"), "--config",
        str(overrides), "--set", "model.quant", "int8", "--checkpoint-dir",
        str(tmp_path / "ckpt"), "--device", "cpu"])
    served = load_serving(art, device="cpu")
    assert served.cfg.model.quant == "int8"
    assert any(getattr(m, "quant", "none") == "int8"
               for m in served.model.model.modules())
    pts, _, rgb = _request(b=1)
    want_boxes, want_probs = served.predict(pts[0], rgb[0])
    srv = make_server(art, port=0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        body = _post(srv.server_address[1], _npz(points=pts[0], rgb=rgb[0]))
    finally:
        srv.shutdown()
        srv.server_close()
    with np.load(io.BytesIO(body)) as z:
        np.testing.assert_array_equal(z["boxes3d"], want_boxes)
        np.testing.assert_array_equal(z["probs"], want_probs)
