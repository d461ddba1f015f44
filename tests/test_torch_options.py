"""The port's model options against the JAX package, on the tiny config of
``__graft_entry__`` in f32 (``model.compute_dtype="float32"``), with the
same (converted) weights and BatchNorm statistics drawn at random:

  * each trunk an option changes (the 7x7/2 stem, basic blocks, the VGG
    rgb trunk, the bilinear deconvs of ``upsample_features``) against
    flax, in eval and in train mode (outputs and BatchNorm statistics),
    on odd input sizes, where flax's SAME padding of the strided convs and
    pools is asymmetric;
  * ``Upsample2D`` with random, asymmetric kernels against flax's
    ``ConvTranspose`` (x2 and x4), which the port computes with the
    kernel flipped;
  * ``FusionHead`` in the siamese, handcraft and learnable modes, in eval
    and train mode; the handcraft gate at a threshold that some rois pass
    and some do not, also when both heads tie;
  * the converter's round trip of every leaf, for every option;
  * ``predict_from_points`` against JAX's ``forward_inference`` for every
    option (the reference graph too: upsampling with the 7x7 stem);
  * one training step's losses, gradients and BatchNorm statistics for
    the siamese, learnable and upsampling + 7x7 configurations, against
    JAX's ``vjp``, on the top view alone (``use_top_only``): an rgb ROI
    corner is an int32 truncation of a projected proposal, and the two
    packages' proposals, a few ulps apart, move one by a pixel on almost
    every draw of these random-weight models (12 of 12 batch draws for the
    siamese model, measured), which changes that ROI's pooled features and
    the fusion losses by up to 2e-2; ``tests/test_torch_train.py`` holds
    the rgb path's step on its one draw where no corner moves.

Tolerances: trunks, heads and the deconv within rtol/atol 1e-4
(``tests/test_torch_models.py``), BatchNorm statistics within rtol 1e-4 /
atol 1e-5 (flax takes the variance as E[x^2] - E[x]^2, the port
two-pass); detections as ``tests/test_torch_slice.py`` (mask exact,
boxes3d within 1e-3, probs within 1e-4 on live slots); the training step
as ``tests/test_torch_train.py`` (losses rtol 1e-4, the full net's
gradients 3e-2 relative L2 per tensor).

The random-weight models put many proposals' scores within f32 noise of
each other, so the two packages' last bits decide some NMS orderings: one
request draw (seed 1) where they decide alike is used for every option,
and each comparison checks that it is not empty.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _tiny_config
from mv3d_tpu.models.backbone import Upsample2D as JaxUpsample2D
from mv3d_tpu.models.mv3d_net import MV3DNet as JaxMV3DNet
from mv3d_tpu.models.mv3d_net import total_loss as jax_total_loss
from mv3d_tpu.models.nets import FusionHead as JaxFusionHead
from mv3d_tpu.models.nets import SUBNET_NAMES
from mv3d_tpu.ops import voxelize as jvox
from mv3d_tpu.train.trainer import _prepare_views as jax_prepare_views
from mv3d_tpu_torch import convert
from mv3d_tpu_torch.data import loader as tloader
from mv3d_tpu_torch.models.backbone import Upsample2D
from mv3d_tpu_torch.models.mv3d_net import MV3DNet, total_loss
from mv3d_tpu_torch.models.nets import FusionHead
from mv3d_tpu_torch.train.trainer import MV3D, _prepare_views

from test_torch_config import to_port_config
from test_torch_models import randomize_bn
from test_torch_train import _flax_grads, _leaves, noise_from_key

torch.set_num_threads(2)

BASE = dataclasses.replace(_tiny_config(), model=dataclasses.replace(
    _tiny_config().model, compute_dtype="float32"))
TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
THRESH = 0.05

OPTIONS = {
    "stem7x7": dict(stem_space_to_depth=False),
    "basic": dict(backbone_block="basic"),
    "vgg": dict(rgb_basenet="vgg"),
    "upsample": dict(upsample_features=True),
    "reference": dict(upsample_features=True, stem_space_to_depth=False),
    "reference_vgg": dict(upsample_features=True, stem_space_to_depth=False,
                          rgb_basenet="vgg"),
    "siamese": dict(use_siamese_fusion=True),
    "handcraft": dict(use_handcraft_fusion=True, high_score_threshold=0.6),
    "learnable": dict(use_learnable_fusion=True),
}


def option_config(name, top_only=False):
    return dataclasses.replace(BASE, model=dataclasses.replace(
        BASE.model, **OPTIONS[name], use_top_only=top_only))


_MODELS = {}


def jax_model(name, top_only=False):
    """(JAX model, its variables with random BatchNorm) of an option,
    shared by the tests of this module."""
    if (name, top_only) not in _MODELS:
        model = JaxMV3DNet(option_config(name, top_only))
        _MODELS[name, top_only] = (model, randomize_bn(
            model.init_variables(jax.random.PRNGKey(0)), seed=5))
    return _MODELS[name, top_only]


def port_model(name, variables, top_only=False):
    model = MV3DNet(to_port_config(option_config(name, top_only)))
    convert.load_variables(model, variables)
    return model


# the trunks each option changes, at odd sizes: (B, H, W, C)
SIZES = {"top_view_rpn": (2, 41, 30, 27), "image_feature": (2, 37, 51, 3),
         "front_feature": (2, 33, 18, 3)}
TRUNK_CASES = [(o, s) for o, subnets in (
    ("stem7x7", SIZES), ("basic", SIZES),
    ("vgg", ("image_feature",)), ("upsample", SIZES),
    ("reference_vgg", ("top_view_rpn", "image_feature")))
    for s in subnets]


def _modules(jm):
    return {"top_view_rpn": jm.top_rpn, "image_feature": jm.rgb_net,
            "front_feature": jm.front_net}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("option,subnet", TRUNK_CASES)
def test_trunk_matches_flax(option, subnet, train):
    jm, variables = jax_model(option)
    x = np.random.RandomState(1).rand(*SIZES[subnet]).astype(np.float32)
    module = port_model(option, variables).subnets[subnet].train(train)
    if train:
        want, up = _modules(jm)[subnet].apply(variables[subnet], x, True,
                                              mutable=["batch_stats"])
    else:
        want = _modules(jm)[subnet].apply(variables[subnet], x, False)
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    if subnet != "top_view_rpn":
        want, got = {"features": want}, {"features": got}
    for k in ("features", "scores", "deltas"):
        if k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       err_msg=k, **TOL)
    if train:
        stats = dict(_leaves(convert.subnet_variables(
            module.state_dict())["batch_stats"]))
        want_stats = dict(_leaves(up["batch_stats"]))
        assert set(stats) == set(want_stats)
        for k, w in want_stats.items():
            np.testing.assert_allclose(stats[k], w, err_msg=k, **STATS_TOL)


@pytest.mark.parametrize("factor,hw", [(2, (5, 7)), (4, (6, 5)),
                                       (4, (13, 10))])
def test_upsample2d_matches_flax_conv_transpose(factor, hw):
    """Random kernels: the bilinear init is symmetric, so only an
    asymmetric kernel shows a missing flip."""
    rng = np.random.RandomState(factor)
    x = rng.randn(2, *hw, 8).astype(np.float32)
    jm = JaxUpsample2D(8, factor, dtype=jnp.float32)
    variables = jax.tree.map(
        lambda a: rng.randn(*a.shape).astype(np.float32),
        jm.init(jax.random.PRNGKey(0), x))
    kernel = variables["params"]["ConvTranspose_0"]["kernel"]
    assert not np.allclose(kernel, kernel[::-1, ::-1])
    want = np.asarray(jm.apply(variables, x))
    tm = Upsample2D(8, factor)
    tm.load_state_dict(convert.subnet_state_dict(variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert want.shape == (2, hw[0] * factor, hw[1] * factor, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_upsample2d_init_is_flax_bilinear():
    """The port's seeded init gives flax's bilinear kernel and zero bias."""
    jm = JaxUpsample2D(6, 4)
    variables = jm.init(jax.random.PRNGKey(0), np.zeros((1, 3, 3, 6)))
    tm = Upsample2D(6, 4)
    tm.init_bilinear()
    back = convert.subnet_variables(tm.state_dict())["params"]
    for leaf in ("kernel", "bias"):
        np.testing.assert_array_equal(
            back["ConvTranspose_0"][leaf],
            np.asarray(variables["params"]["ConvTranspose_0"][leaf]))


def _head_case(mode, tie):
    """(cfg, views, roi features, flax variables) of a fusion head."""
    siamese = mode == "siamese"
    cfg = option_config(mode if mode != "siamese_learnable" else "siamese")
    if mode == "siamese_learnable":
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, use_learnable_fusion=True))
        siamese = True
    views = ["top"] if tie else ["top", "rgb"]
    rng = np.random.RandomState(2)
    feats = {v: rng.randn(12, 6, 6, 128).astype(np.float32) for v in views}
    if siamese:
        feats.update({v + "_ctx": rng.randn(12, 6, 6, 128).astype(
            np.float32) for v in views})
    jhead = JaxFusionHead(cfg=cfg, dtype=jnp.float32)
    variables = randomize_bn(jhead.init(jax.random.PRNGKey(3), feats), 4)
    if tie:
        # the without-rgb branch made the with-rgb branch's twin, except
        # the box regression's last layer: equal fg probs, other deltas
        p = variables["params"]
        for a, b in (("fc_wo_rgb_1", "fc_all_1"), ("fc_wo_rgb_2", "fc_all_2")):
            p[a] = p[b]
            variables["batch_stats"][a] = variables["batch_stats"][b]
        for layer in ("score", "box_1", "box_2"):
            p["head_without_rgb"][layer] = p["head_with_rgb"][layer]
            if layer in variables["batch_stats"]["head_with_rgb"]:
                variables["batch_stats"]["head_without_rgb"][layer] = \
                    variables["batch_stats"]["head_with_rgb"][layer]
    return cfg, views, feats, jhead, variables


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mode,tie", [
    ("siamese", False), ("handcraft", False), ("handcraft", True),
    ("learnable", False), ("siamese_learnable", False)])
def test_fusion_head_modes_match_flax(mode, tie, train):
    cfg, views, feats, jhead, variables = _head_case(mode, tie)
    if mode == "handcraft":
        # a gate between the rois' fg probs: some pass it, some do not
        out = jhead.apply(variables, feats, train,
                          **({"mutable": ["batch_stats"]} if train else {}))
        out = out[0] if train else out
        best = np.maximum(np.asarray(out["probs_with_rgb"])[:, 1],
                          np.asarray(out["probs_without_rgb"])[:, 1])
        thr = float(np.median(best))
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, high_score_threshold=thr))
        jhead = JaxFusionHead(cfg=cfg, dtype=jnp.float32)
        assert 0 < (best > thr).sum() < len(best)
        pw = np.asarray(out["probs_with_rgb"])[:, 1]
        pwo = np.asarray(out["probs_without_rgb"])[:, 1]
        assert (pw == pwo).all() if tie else not (pw == pwo).any()
    if train:
        want, up = jhead.apply(variables, feats, True,
                               mutable=["batch_stats"])
    else:
        want = jhead.apply(variables, feats, False)
    head = FusionHead(to_port_config(cfg), views)
    head.load_state_dict(convert.subnet_state_dict(variables))
    head.train(train)
    with torch.no_grad():
        got = head({v: torch.from_numpy(a) for v, a in feats.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    if mode != "siamese":
        assert not np.array_equal(np.asarray(want["deltas_with_rgb"]),
                                  np.asarray(want["deltas_without_rgb"]))
    if train:
        stats = dict(_leaves(convert.subnet_variables(
            head.state_dict())["batch_stats"]))
        for k, w in _leaves(up["batch_stats"]):
            np.testing.assert_allclose(stats[k], w, err_msg=k, **STATS_TOL)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_convert_round_trips_every_option(option):
    _, variables = jax_model(option)
    model = port_model(option, variables)
    n_leaves = 0
    for name in SUBNET_NAMES:
        back = convert.subnet_variables(model.subnets[name].state_dict())
        flat_in = jax.tree_util.tree_flatten_with_path(variables[name])[0]
        flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_in) == len(flat_back)
        for path, arr in flat_in:
            np.testing.assert_array_equal(flat_back[path], arr,
                                          err_msg=jax.tree_util.keystr(path))
            n_leaves += 1
    assert n_leaves > 200


def _request(seed=1, b=2):
    rng = np.random.RandomState(seed)
    n, t = BASE.pipeline.max_points, BASE.top
    pts = np.stack([rng.uniform(t.x_min, t.x_max, (b, n)),
                    rng.uniform(t.y_min, t.y_max, (b, n)),
                    rng.uniform(t.z_min, t.z_max, (b, n)),
                    rng.uniform(0, 1, (b, n))], axis=-1).astype(np.float32)
    return (pts, np.array([n, n - 300], np.int32)[:b],
            rng.rand(b, *BASE.rgb_shape).astype(np.float32))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_forward_inference_matches_jax(option):
    cfg = option_config(option)
    jm, variables = jax_model(option)
    pts, num, rgb = _request()
    # eagerly: under jit XLA folds the quantization's division
    top, occ = jvox.lidar_to_top_batch(jnp.asarray(pts), cfg,
                                       jnp.asarray(num), return_occ=True)
    jdets, _ = jax.jit(lambda v, t, r, o: jm.forward_inference(
        v, t, r, None, score_threshold=THRESH, top_occ=o))(
        variables, top, rgb, occ)
    port = MV3D(to_port_config(cfg), device="cpu", variables=variables)
    dets = port.predict_from_points(pts, num, rgb, score_threshold=THRESH)
    m = np.asarray(jdets.mask)
    assert m.sum() >= 2, "too few live detections to compare"
    np.testing.assert_array_equal(dets.mask.numpy(), m)
    np.testing.assert_allclose(dets.boxes3d.numpy()[m],
                               np.asarray(jdets.boxes3d)[m], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(dets.probs.numpy()[m],
                               np.asarray(jdets.probs)[m], rtol=0, atol=1e-4)


# -- one training step -------------------------------------------------------

TRAIN_OPTIONS = ["siamese", "learnable", "reference"]


@pytest.fixture(scope="module")
def train_batch():
    drive = chip_smoke.SynthDrive(np.random.RandomState(2),
                                  to_port_config(BASE), 2, 3000, cars=(2, 3))
    batch = tloader.frames_to_batch(drive.frames, to_port_config(BASE))
    return {k: v for k, v in batch.items() if k != "tags"}


@pytest.mark.parametrize("option", TRAIN_OPTIONS)
def test_training_step_matches_jax_vjp(option, train_batch):
    """The full net's losses, every gradient (relative L2 3e-2 per
    tensor, as tests/test_torch_train.py) and the BatchNorm statistics of
    one train-mode step, against the JAX step's vjp on the same draws."""
    cfg = option_config(option, top_only=True)
    jm, variables = jax_model(option, top_only=True)
    key = jax.random.PRNGKey(11)

    @jax.jit
    def ref(variables, batch):
        params = {n: variables[n]["params"] for n in SUBNET_NAMES}

        def f(p):
            var = {n: {"params": p[n],
                       "batch_stats": variables[n]["batch_stats"]}
                   for n in SUBNET_NAMES}
            ld, aux = jm.forward_train(var, batch, key, train=True)
            return jax_total_loss(ld, SUBNET_NAMES, cfg), (ld, aux)

        _, vjp, (ld, aux) = jax.vjp(f, params, has_aux=True)
        grads, = vjp(jnp.float32(1.0))
        return ld, aux["updates"], grads

    views = jax_prepare_views({k: jnp.asarray(v)
                               for k, v in train_batch.items()}, cfg)
    want_ld, updates, want_grads = jax.tree.map(np.asarray,
                                                ref(variables, views))

    pcfg = to_port_config(cfg)
    model = port_model(option, variables, top_only=True)
    batch = _prepare_views({k: torch.from_numpy(v)
                            for k, v in train_batch.items()}, pcfg, False)
    noise = {k: torch.from_numpy(v)
             for k, v in noise_from_key(key, 2, cfg).items()}
    ld, _ = model.forward_train(batch, noise)
    for k, w in want_ld.items():
        np.testing.assert_allclose(ld[k].item(), w, rtol=1e-4, err_msg=k)
    total_loss(ld, SUBNET_NAMES, pcfg).backward()
    n_checked = 0
    for subnet in SUBNET_NAMES:
        got = dict(_leaves(_flax_grads(model.subnets[subnet])))
        want = dict(_leaves(want_grads[subnet]))
        assert set(got) == set(want), subnet
        for name, w in want.items():
            err = f"{subnet}/{name}"
            if not np.abs(w).max():       # unused: the fc_wo_rgb layers
                np.testing.assert_array_equal(got[name], w, err_msg=err)
                continue
            if option == "learnable" and name.endswith("box_3/bias"):
                # zero in exact arithmetic: fuse_deltas' train-mode
                # BatchNorm cancels any shift of its inputs, so both
                # packages hold f32 noise (~2e-7) here
                assert max(np.abs(w).max(), np.abs(got[name]).max()) < 1e-5
                continue
            rel = np.linalg.norm(got[name] - w) / np.linalg.norm(w)
            assert rel < 3e-2, (err, rel)
            n_checked += 1
        if updates.get(subnet) is None:      # the rgb and front trunks
            continue
        stats = dict(_leaves(convert.subnet_variables(
            model.subnets[subnet].state_dict())["batch_stats"]))
        for k, w in _leaves(updates[subnet]["batch_stats"]):
            np.testing.assert_allclose(stats[k], w, err_msg=f"{subnet}/{k}",
                                       **STATS_TOL)
    assert n_checked > 100
