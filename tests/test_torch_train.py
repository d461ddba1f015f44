"""The port's training step against the JAX package's, on the tiny config
of ``__graft_entry__`` with f32 compute and the default host aux plane:
one synthetic batch (two frames with planted gt cars) from the port's
loader, the same converted weights (BatchNorm statistics randomized) and
the JAX step's own uniform draws, taken along its key-split chain.

The rgb ROI corners are int-pixel truncations of projected proposals: a
last-bit difference in a proposal can move one by a pixel, which changes
that ROI's pooled rgb features and with them the fusion head's batch
statistics (measured on other seeds: fusion losses off by up to 5e-3).
The batch's seed is one where no corner moves, and the test checks it.

Tolerances: target masks and labels exact; losses within rtol 1e-4;
gradients of the RPN stage within 1e-3 of each tensor's max |g|, of the
full net within 3e-2 relative L2 per tensor (see that test: ReLU kinks in
the fusion head); BatchNorm running statistics within rtol 1e-4 / atol
1e-5 (their inputs differ by ~1e-5 between the two f32 forwards, and
flax takes the variance as E[x^2] - E[x]^2, the port two-pass); one Adam
step within 2 f32 ulps of the weight (rtol 2.4e-7) plus 1e-5 of the
step size lr = 1e-3 (atol 1e-8: torch and optax round the bias
corrections differently) of optax's step on the same gradients, where
|g| > 1e-5 (the first step is about lr * sign(g)); the learning-rate
schedule and the gradient clip within rtol 1e-6 of optax; frozen subnets
bit-unchanged; checkpoints bit-exact both ways.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from __graft_entry__ import _tiny_config
from mv3d_tpu.models.mv3d_net import MV3DNet as JaxMV3DNet
from mv3d_tpu.models.mv3d_net import (
    project_to_rgb_roi as jax_project_to_rgb_roi)
from mv3d_tpu.models.mv3d_net import total_loss as jax_total_loss
from mv3d_tpu.models.nets import SUBNET_NAMES, TOP_VIEW_RPN
from mv3d_tpu.train import augment as jaugment
from mv3d_tpu.train import checkpoint as jckpt
from mv3d_tpu.train import losses as jlosses
from mv3d_tpu.train import targets as jtargets
from mv3d_tpu.train.trainer import _prepare_views as jax_prepare_views
from mv3d_tpu_torch import convert
from mv3d_tpu_torch.data import loader as tloader
from mv3d_tpu_torch.models.mv3d_net import (MV3DNet, project_to_rgb_roi,
                                            total_loss)
from mv3d_tpu_torch.train import augment as taugment
from mv3d_tpu_torch.train import losses as tlosses
from mv3d_tpu_torch.train import targets as ttargets
from mv3d_tpu_torch.train.trainer import (MV3D, Trainer, _prepare_views,
                                          lr_schedule)

from test_torch_config import to_port_config
from test_torch_models import randomize_bn

torch.set_num_threads(2)

CFG = dataclasses.replace(_tiny_config(), model=dataclasses.replace(
    _tiny_config().model, compute_dtype="float32"))
PCFG = to_port_config(CFG)
STAGES = {"rpn": (TOP_VIEW_RPN,), "all": SUBNET_NAMES}


def noise_from_key(key, b, cfg):
    """The JAX step's draws for ``forward_train(.., key)``: per frame
    (k1, k2) = split(key_i); rpn_target splits k1 into pos/neg, and
    fusion_target k2 into fg/fp."""
    a = cfg.num_anchors
    e = cfg.rpn.nms_post_topn + cfg.pipeline.max_gt
    out = {k: [] for k in ("rpn_pos", "rpn_neg", "fus_fg", "fus_fp")}
    for key_i in jax.random.split(key, b):
        k1, k2 = jax.random.split(key_i)
        for name, k, n in zip(out, [*jax.random.split(k1),
                                    *jax.random.split(k2)], (a, a, e, e)):
            out[name].append(np.asarray(jax.random.uniform(k, (n,))))
    return {k: np.stack(v) for k, v in out.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _flax_grads(module):
    """A module's parameter gradients in flax layout (None -> 0)."""
    sd = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
          for n, p in module.named_parameters()}
    return convert.subnet_variables(sd)["params"]


@pytest.fixture(scope="module")
def batch_np():
    drive = chip_smoke.SynthDrive(np.random.RandomState(2), PCFG, 2, 3000,
                                  cars=(2, 3))
    batch = tloader.frames_to_batch(drive.frames, PCFG)
    return {k: v for k, v in batch.items() if k != "tags"}


@pytest.fixture(scope="module")
def reference(batch_np):
    """The JAX step's losses, targets, BatchNorm updates and the gradients
    of both stages' losses, from one jitted vjp."""
    jm = JaxMV3DNet(CFG)
    variables = randomize_bn(jax.jit(jm.init_variables)(
        jax.random.PRNGKey(0)), seed=3)
    key = jax.random.PRNGKey(11)

    @jax.jit
    def ref(variables, batch, key):
        params = {n: variables[n]["params"] for n in SUBNET_NAMES}

        def f(p):
            var = {n: {"params": p[n],
                       "batch_stats": variables[n]["batch_stats"]}
                   for n in SUBNET_NAMES}
            ld, aux = jm.forward_train(var, batch, key, train=True)
            return jnp.stack([jax_total_loss(ld, STAGES["rpn"], CFG),
                              jax_total_loss(ld, STAGES["all"], CFG)]), \
                (ld, aux)

        _, vjp, (ld, aux) = jax.vjp(f, params, has_aux=True)
        g_rpn, = vjp(jnp.array([1.0, 0.0]))
        g_all, = vjp(jnp.array([0.0, 1.0]))
        return (ld, aux["rpn_targets"], aux["fusion_targets"],
                aux["updates"], {"rpn": g_rpn, "all": g_all})

    # the views are made eagerly: under jit XLA folds the quantization's
    # division by a constant into a reciprocal multiply, which moves
    # heights by an ulp in hundreds of cells (and some points by a cell)
    # against the numpy oracle, which the port and eager JAX match
    views = jax_prepare_views({k: jnp.asarray(v)
                               for k, v in batch_np.items()}, CFG)
    out = jax.tree.map(np.asarray, ref(variables, views, key))
    return dict(zip(("losses", "rpn_tg", "fus_tg", "updates", "grads"),
                    out), variables=variables,
                noise=noise_from_key(key, 2, CFG))


@pytest.fixture(scope="module")
def port(reference, batch_np):
    """The port's forward_train on the same weights and draws, then the
    gradients of both stages' losses."""
    model = MV3DNet(PCFG)
    convert.load_variables(model, reference["variables"])
    batch = _prepare_views({k: torch.from_numpy(v)
                            for k, v in batch_np.items()}, PCFG, False)
    noise = {k: torch.from_numpy(v) for k, v in reference["noise"].items()}
    ld, aux = model.forward_train(batch, noise)
    grads = {}
    for stage, names in STAGES.items():
        model.zero_grad(set_to_none=True)
        loss = total_loss(ld, names, PCFG)
        loss.backward(retain_graph=True,
                      inputs=[p for n in names
                              for p in model.subnets[n].parameters()])
        grads[stage] = {n: _flax_grads(model.subnets[n]) for n in names}
    return dict(model=model, losses=ld, aux=aux, grads=grads)


def test_forward_train_losses_and_targets_match_jax(reference, port):
    for k, want in reference["losses"].items():
        np.testing.assert_allclose(port["losses"][k].item(), want,
                                   rtol=1e-4, err_msg=k)
    rpn, fus = port["aux"]["rpn_targets"], port["aux"]["fusion_targets"]
    assert reference["rpn_tg"].pos_mask.sum() > 0
    assert reference["fus_tg"].pos_mask.sum() > 0
    for k in ("cls_mask", "labels", "pos_mask"):
        np.testing.assert_array_equal(getattr(rpn, k).numpy(),
                                      getattr(reference["rpn_tg"], k), k)
    for k in ("mask", "labels", "pos_mask"):
        np.testing.assert_array_equal(getattr(fus, k).numpy(),
                                      getattr(reference["fus_tg"], k), k)
    np.testing.assert_allclose(fus.rois.detach().numpy(),
                               reference["fus_tg"].rois, rtol=0, atol=1e-3)
    got = project_to_rgb_roi(fus.rois3d.detach(), PCFG).numpy()
    want = np.stack([np.asarray(jax_project_to_rgb_roi(r, CFG))
                     for r in reference["fus_tg"].rois3d])
    assert (got != want).sum() == 0, "an rgb ROI corner moved by a pixel"


@pytest.mark.parametrize("stage", ["rpn", "all"])
def test_gradients_match_jax(reference, port, stage):
    """Stage ``top_view_rpn``: every gradient within 1e-3 of its tensor's
    max |g|. Stage ``all``: each tensor's relative L2 error within 3e-2.

    The full net's gradient runs back through the fusion head in train
    mode, where ReLU inputs lie within 1e-6 of zero (many on the dead roi
    slots, which share one value) and the two packages' f32 forwards,
    1e-5 apart, put them on different sides of the kink: an f32 run of
    the port against an f64 run of itself differs by as much (4% of max
    on an isolated fusion head, measured). On this batch the full net's
    worst relative L2 error is 1.1e-2 (rpn_conv), with no tensor inside
    1e-3 of max; the RPN stage has no fusion path and agrees to 1.3e-5.
    """
    n_checked = 0
    for subnet, got in port["grads"][stage].items():
        want = dict(_leaves(reference["grads"][stage][subnet]))
        got = dict(_leaves(got))
        assert set(got) == set(want), subnet
        for name, w in want.items():
            err = f"{subnet}/{name}"
            if not np.abs(w).max():       # unused: the fc_wo_rgb layers
                np.testing.assert_array_equal(got[name], w, err_msg=err)
            elif stage == "rpn":
                np.testing.assert_allclose(got[name], w, rtol=0,
                                           atol=1e-3 * np.abs(w).max(),
                                           err_msg=err)
            else:
                rel = np.linalg.norm(got[name] - w) / np.linalg.norm(w)
                assert rel < 3e-2, (err, rel)
            n_checked += np.abs(w).max() > 0
    assert n_checked > (70 if stage == "rpn" else 190)


def test_batchnorm_running_stats_match_jax(reference, port):
    """After one train-mode forward: flax's momentum 0.9 and biased batch
    variance, in every subnet that ran; the unused front trunk keeps its
    statistics."""
    model = port["model"]
    for subnet, module in model.subnets.items():
        got = dict(_leaves(convert.subnet_variables(
            module.state_dict())["batch_stats"]))
        up = reference["updates"].get(subnet)
        before = dict(_leaves(reference["variables"][subnet]["batch_stats"]))
        if up is None:
            assert subnet == "front_feature"
            for k, v in got.items():
                np.testing.assert_array_equal(v, before[k], err_msg=k)
            continue
        want = dict(_leaves(up["batch_stats"]))
        assert set(got) == set(want)
        moved = 0
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{subnet}/{k}")
            moved += not np.array_equal(w, before[k])
        assert moved == len(want), subnet


class FixedSet:
    def __init__(self, batch):
        self.batch = batch

    def load(self):
        return self.batch


def _trainer(tmp_path, batch_np, variables, stage, **train):
    cfg = dataclasses.replace(PCFG, train=dataclasses.replace(
        PCFG.train, **train))
    return Trainer(FixedSet(batch_np), train_targets=STAGES[stage], cfg=cfg,
                   device="cpu", variables=variables, lr=1e-3,
                   checkpoint_dir=str(tmp_path / "ckpt"),
                   log_dir=str(tmp_path / "log"))


@pytest.mark.parametrize("stage,train", [
    ("rpn", {}),
    ("all", {"lr_schedule": "cosine", "warmup_steps": 0,
             "decay_steps": 50, "grad_clip_norm": 1e3})])
def test_adam_step_and_frozen_subnets(tmp_path, reference, batch_np, stage,
                                      train):
    """One ``fit_iteration``: the trained subnets take optax's Adam step
    on the port's gradients; frozen subnets' parameters stay bit-equal
    while their BatchNorm statistics move (they run in train mode)."""
    tr = _trainer(tmp_path, batch_np, reference["variables"], stage, **train)
    before = tr.get_variables()
    losses = tr.fit_iteration(batch_np)
    assert np.isfinite(list(losses.values())).all()
    after = tr.get_variables()
    names = STAGES[stage]
    params0 = {n: before[n]["params"] for n in names}
    grads = {n: _flax_grads(tr.model.subnets[n]) for n in names}
    tx = optax.adam(lr_schedule(tr.cfg, 1e-3)(0))
    updates, _ = tx.update(grads, tx.init(params0), params0)
    want = optax.apply_updates(params0, updates)
    n_moved = 0
    for n in names:
        g = dict(_leaves(grads[n]))
        w = dict(_leaves(want[n]))
        for k, got in _leaves(after[n]["params"]):
            big = np.abs(g[k]) > 1e-5
            np.testing.assert_allclose(got[big], np.asarray(w[k])[big],
                                       rtol=2.4e-7, atol=1e-8, err_msg=k)
            n_moved += big.sum()
    assert n_moved > 1000
    for n in set(SUBNET_NAMES) - set(names):
        for k, v in _leaves(before[n]["params"]):
            np.testing.assert_array_equal(dict(_leaves(after[n]["params"]))[k],
                                          v, err_msg=f"{n}/{k}")
        stats0 = dict(_leaves(before[n]["batch_stats"]))
        moved = [not np.array_equal(v, stats0[k])
                 for k, v in _leaves(after[n]["batch_stats"])]
        assert all(moved) if n != "front_feature" else not any(moved)


def test_lr_schedule_and_grad_clip_match_optax(tmp_path, batch_np,
                                               reference):
    cfg = dataclasses.replace(PCFG, train=dataclasses.replace(
        PCFG.train, lr_schedule="cosine", warmup_steps=10, decay_steps=100,
        lr_end_factor=0.01, grad_clip_norm=0.5))
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=2e-3, warmup_steps=10, decay_steps=100,
        end_value=2e-5)
    got = lr_schedule(cfg, 2e-3)
    for count in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, err_msg=str(count))
    assert lr_schedule(PCFG, 3e-4)(7) == 3e-4

    tr = _trainer(tmp_path, batch_np, reference["variables"], "rpn",
                  grad_clip_norm=0.5)
    rng = np.random.RandomState(0)
    grads = {}
    for name, p in tr.model.top_rpn.named_parameters():
        p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
        grads[name] = p.grad.numpy().copy()
    tr._clip_grads()
    clip = optax.clip_by_global_norm(0.5)
    want, _ = clip.update(grads, clip.init(grads))
    for name, p in tr.model.top_rpn.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-9, err_msg=name)


def test_checkpoints_cross_both_ways(tmp_path, reference):
    """Port -> JAX: the JAX checkpointer reads what the port saved. JAX ->
    port: the port loads what the JAX checkpointer saved."""
    src = MV3D(PCFG, device="cpu", seed=4, checkpoint_dir=str(tmp_path),
               log_tag="port", log_dir=str(tmp_path / "log"))
    src.save_weights(step=7)
    saved = src.get_variables()
    for name in SUBNET_NAMES:
        got = jckpt.SubnetCheckpointer(
            name, str(tmp_path / "port")).load()
        want = dict(_leaves(saved[name]))
        assert dict(_leaves(got)).keys() == want.keys()
        for k, v in _leaves(got):
            np.testing.assert_array_equal(v, want[k], err_msg=k)

    for name in SUBNET_NAMES:
        jckpt.SubnetCheckpointer(name, str(tmp_path / "jax")).save(
            reference["variables"][name], 3)
    dst = MV3D(PCFG, device="cpu", seed=5, checkpoint_dir=str(tmp_path),
               log_tag="jax", log_dir=str(tmp_path / "log"))
    dst.load_weights()
    loaded = dst.get_variables()
    for name in SUBNET_NAMES:
        want = dict(_leaves(reference["variables"][name]))
        for k, v in _leaves(loaded[name]):
            np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_training_loop_checkpoints_and_nan_crash_save(tmp_path, batch_np,
                                                      reference):
    """``__call__``: skips batches without positive gt, logs each step,
    saves at the cadence and at the end; a NaN loss writes the crash
    checkpoint and raises."""
    empty = dict(batch_np, gt_mask=np.zeros_like(batch_np["gt_mask"]))
    tr = _trainer(tmp_path, batch_np, reference["variables"], "rpn",
                  ckpt_every=2)
    tr.train_set = type("Alt", (), {"n": 0, "load": lambda self: (
        empty if (setattr(self, "n", self.n + 1) or self.n == 2)
        else batch_np)})()
    last = tr(4)
    assert np.isfinite(list(last.values())).all()
    assert tr.n_global_step == 4
    ckpt = tmp_path / "ckpt" / "default" / TOP_VIEW_RPN
    assert sorted(os.listdir(ckpt)) == [f"{TOP_VIEW_RPN}-2.npz",
                                        f"{TOP_VIEW_RPN}-4.npz"]
    with open(tmp_path / "log" / "log.txt") as f:
        assert sum("training:" in line for line in f) == 3
    with torch.no_grad():
        tr.model.top_rpn.rpn_score.bias.fill_(float("nan"))
    tr.train_set = FixedSet(batch_np)
    with pytest.raises(FloatingPointError):
        tr(1)
    assert os.path.exists(ckpt / f"{TOP_VIEW_RPN}-crash.npz")


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    b, a, r = 2, 300, 40
    rpn_tg = jtargets.RpnTargets(
        cls_mask=rng.rand(b, a) < 0.3, labels=rng.randint(0, 2, (b, a)),
        pos_mask=rng.rand(b, a) < 0.1,
        targets=rng.randn(b, a, 4).astype(np.float32))
    scores = rng.randn(b, a, 2).astype(np.float32)
    deltas = (rng.randn(b, a, 4) * 0.3).astype(np.float32)
    got = tlosses.rpn_loss(torch.from_numpy(scores), torch.from_numpy(deltas),
                           ttargets.RpnTargets(*map(torch.from_numpy,
                                                    rpn_tg)))
    for i in range(b):
        want = jlosses.rpn_loss(scores[i], deltas[i], jax.tree.map(
            lambda x: x[i], rpn_tg))
        np.testing.assert_allclose([g[i].item() for g in got], want,
                                   rtol=1e-6)
    fus_tg = jtargets.FusionTargets(
        rois=np.zeros((r, 5), np.float32), labels=rng.randint(0, 2, r),
        targets=(rng.randn(r, 8, 3) * 0.2).astype(np.float32),
        mask=rng.rand(r) < 0.8, pos_mask=rng.rand(r) < 0.3,
        rois3d=np.zeros((r, 8, 3), np.float32))
    fs = rng.randn(r, 2).astype(np.float32)
    fd = (rng.randn(r, 2, 8, 3) * 0.3).astype(np.float32)
    got = tlosses.fuse_loss(torch.from_numpy(fs), torch.from_numpy(fd),
                            ttargets.FusionTargets(*map(torch.from_numpy,
                                                        fus_tg)))
    np.testing.assert_allclose([g.item() for g in got],
                               jlosses.fuse_loss(fs, fd, fus_tg), rtol=1e-6)


def test_augmentation_with_injected_draws_matches_jax(batch_np):
    """Flip and rotation draws taken from the JAX key chain (per frame
    (kf, kr) = split(key_i)) and injected into the port; with both knobs
    at 0 the batch comes back as is and no draw is made."""
    cfg = dataclasses.replace(CFG, train=dataclasses.replace(
        CFG.train, aug_flip_prob=0.5, aug_rotate_rad=0.4))
    key = jax.random.PRNGKey(0)
    flip, theta = [], []
    for k in jax.random.split(key, 2):
        kf, kr = jax.random.split(k)
        flip.append(bool(jax.random.uniform(kf) < 0.5))
        theta.append(float(jax.random.uniform(kr, minval=-0.4, maxval=0.4)))
    assert any(flip) and not all(flip)
    want = jaugment.augment_batch(
        {k: jnp.asarray(batch_np[k]) for k in ("points", "gt_boxes3d")},
        key, cfg)
    pts, gt3d = taugment.augment_frames(
        torch.from_numpy(batch_np["points"]),
        torch.from_numpy(batch_np["gt_boxes3d"]), torch.tensor(flip),
        torch.tensor(theta, dtype=torch.float32))
    np.testing.assert_allclose(pts.numpy(), np.asarray(want["points"]),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(gt3d.numpy(), np.asarray(want["gt_boxes3d"]),
                               rtol=0, atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    assert taugment.augment_batch(batch, PCFG, gen) is batch
    assert torch.equal(gen.get_state(),
                       torch.Generator().manual_seed(0).get_state())


def test_entry_points_default_to_the_card(tmp_path):
    """``MV3D`` and ``Trainer`` run on the card unless given a device, and
    raise where there is no CUDA; the CPU reference asks for the CPU."""
    kw = dict(checkpoint_dir=str(tmp_path), log_dir=str(tmp_path))
    if torch.cuda.is_available():
        assert MV3D(PCFG, **kw).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        MV3D(PCFG, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(None, cfg=PCFG, **kw)
    assert MV3D(PCFG, device="cpu", **kw).device.type == "cpu"
