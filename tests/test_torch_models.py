"""Port parity of the networks: each trunk and the FusionHead against the
flax modules with the same (converted) weights, in f32
(``model.compute_dtype="float32"``), within rtol/atol 1e-4; the weight
converter round-trips every parameter; a quantization the port does not
have raises (the other options: tests/test_torch_options.py; int8:
tests/test_torch_quantized.py).

BatchNorm statistics and affine parameters are drawn at random (flax
initializes them to the identity), so the converter's BatchNorm mapping is
exercised, not just its kernels.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from mv3d_tpu.models.mv3d_net import MV3DNet as JaxMV3DNet
from mv3d_tpu.models.nets import FusionHead as JaxFusionHead
from mv3d_tpu_torch import convert
from mv3d_tpu_torch.models.mv3d_net import MV3DNet
from mv3d_tpu_torch.models.nets import SUBNET_NAMES, FusionHead

from test_torch_config import to_port_config

torch.set_num_threads(2)

CFG = dataclasses.replace(_tiny_config(), model=dataclasses.replace(
    _tiny_config().model, compute_dtype="float32"))
PCFG = to_port_config(CFG)
TOL = dict(rtol=1e-4, atol=1e-4)


def randomize_bn(variables, seed=0):
    """Random BatchNorm scale/bias/mean/var (positive var) in a flax tree."""
    rng = np.random.RandomState(seed)

    def walk(tree, bn=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                # a BatchNorm by its leaves: flax names the split stem's
                # "stem_bn", the others "BatchNorm_<i>"
                out[k] = walk(v, bn or bool({"scale", "mean"} & set(v)))
            elif bn:
                shape = np.shape(v)
                out[k] = {"scale": rng.uniform(0.5, 1.5, shape),
                          "bias": rng.normal(0, 0.1, shape),
                          "mean": rng.normal(0, 0.1, shape),
                          "var": rng.uniform(0.5, 1.5, shape)}[k].astype(
                              np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(jax.tree.map(np.asarray, variables))


@pytest.fixture(scope="module")
def jax_model():
    model = JaxMV3DNet(CFG)
    variables = randomize_bn(jax.jit(model.init_variables)(
        jax.random.PRNGKey(0)))
    return model, variables


@pytest.fixture(scope="module")
def torch_model(jax_model):
    _, variables = jax_model
    model = MV3DNet(PCFG)
    convert.load_variables(model, variables)
    return model.eval()


def _views(seed=1):
    rng = np.random.RandomState(seed)
    top = (rng.rand(2, *CFG.top_shape) * (rng.rand(2, *CFG.top_shape) < 0.2)
           ).astype(np.float32)
    rgb = rng.rand(2, *CFG.rgb_shape).astype(np.float32)
    front = rng.rand(2, *CFG.front_shape).astype(np.float32)
    return top, rgb, front


@pytest.mark.parametrize("subnet", ["top_view_rpn", "image_feature",
                                    "front_feature"])
def test_trunk_matches_flax(jax_model, torch_model, subnet):
    jm, variables = jax_model
    top, rgb, front = _views()
    module, x = {"top_view_rpn": (jm.top_rpn, top),
                 "image_feature": (jm.rgb_net, rgb),
                 "front_feature": (jm.front_net, front)}[subnet]
    want = jax.jit(lambda v, a: module.apply(v, a, False))(
        variables[subnet], x)
    with torch.no_grad():
        got = torch_model.subnets[subnet](torch.from_numpy(x))
    if subnet != "top_view_rpn":
        want, got = {"features": want}, {"features": got}
    for k in ("features", "scores", "deltas"):
        if k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("use_front", [False, True])
def test_fusion_head_matches_flax(use_front):
    cfg = dataclasses.replace(CFG, model=dataclasses.replace(
        CFG.model, use_front=use_front))
    views = ["top", "front", "rgb"] if use_front else ["top", "rgb"]
    rng = np.random.RandomState(2)
    feats = {v: rng.randn(5, 6, 6, 128).astype(np.float32) for v in views}
    jhead = JaxFusionHead(cfg=cfg, dtype=np.float32)
    variables = randomize_bn(jhead.init(jax.random.PRNGKey(3), feats), 4)
    want = jax.jit(lambda v, f: jhead.apply(v, f, False))(variables, feats)
    head = FusionHead(to_port_config(cfg), views)
    head.load_state_dict(convert.subnet_state_dict(variables))
    with torch.no_grad():
        got = head.eval()({v: torch.from_numpy(a) for v, a in feats.items()})
    for k in ("scores", "probs", "deltas"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_convert_round_trips_every_parameter(jax_model, torch_model):
    _, variables = jax_model
    n_leaves = 0
    for name in SUBNET_NAMES:
        sd = torch_model.subnets[name].state_dict()
        back = convert.subnet_variables(sd)
        flat_in = jax.tree_util.tree_flatten_with_path(variables[name])[0]
        flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_in) == len(flat_back)
        for path, arr in flat_in:
            np.testing.assert_array_equal(flat_back[path], arr,
                                          err_msg=jax.tree_util.keystr(path))
            n_leaves += 1
    assert n_leaves > 300


def test_seeded_init_is_deterministic():
    a, b = MV3DNet(PCFG), MV3DNet(PCFG)
    a.init_weights(torch.Generator().manual_seed(11))
    b.init_weights(torch.Generator().manual_seed(11))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka


def test_bf16_compute_keeps_batchnorm_f32():
    cfg = dataclasses.replace(PCFG, model=dataclasses.replace(
        PCFG.model, compute_dtype="bfloat16"))
    model = MV3DNet(cfg)
    assert model.top_rpn.trunk.ConvBnRelu_0.Conv_0.weight.dtype \
        == torch.bfloat16
    assert model.top_rpn.trunk.ConvBnRelu_0.BatchNorm_0.weight.dtype \
        == torch.float32
    out = model.eval().top_rpn(torch.rand(1, *cfg.top_shape))
    assert out["scores"].dtype == torch.float32
    assert out["features"].dtype == torch.bfloat16


@pytest.mark.parametrize("field,value", [("quant", "int4")])
def test_unported_model_options_raise(field, value):
    cfg = dataclasses.replace(PCFG, model=dataclasses.replace(
        PCFG.model, **{field: value}))
    with pytest.raises(ValueError, match=value):
        MV3DNet(cfg)
