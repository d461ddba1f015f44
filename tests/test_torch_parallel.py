"""The port's data parallelism (``mv3d_tpu_torch.parallel.mesh`` and the
``"dcp"`` checkpoint backend) against ``tests/test_multichip.py`` and
``tests/test_distributed.py``'s contract, on the CPU: gloo process groups
of spawned processes (file-store rendezvous), each child joined with its
own timeout, so a hang fails the test.

Two runs, each shared by the tests of this module:

  * 4 processes build the meshes: (data, model) with a model axis of 1
    and 2, the hybrid (dcn, data, model) mesh, and their batch splits;
  * 2 processes run the tiny config (f32 compute, the converted JAX
    weights with random BatchNorm statistics): 2 sharded training steps
    of every subnet at 2 x 1 frames with JAX's draws, sharded inference
    (float and int8, and int8 with per-shard scales), and a ``"dcp"``
    checkpoint saved and restored by both ranks.

References, computed here in one process: the port's ``Trainer`` step at
the global batch of 2 frames (the same weights, batch and draws), and
``MV3D.predict_from_points`` on the global batch; and JAX's
``make_sharded_train_step`` on a 2-device mesh of the conftest's virtual
CPU devices (views made eagerly, see tests/test_torch_train.py).

Tolerances. Against the port's one-process step, after each step:
losses within rtol 1e-5; BatchNorm running statistics within rtol 1e-4
and atol 1e-5 of each tensor's magnitude (at least 1; the stem's means
run to ~40); Adam's moments within 3e-2 relative L2 per tensor (the full
net's gradient tolerance of tests/test_torch_train.py: ReLU kinks in the
fusion head; measured 1.1e-2); the parameters within 2.1 lr per step
of each other everywhere, and where the gradient's sign is sure (|m|
above 1e-3 of the tensor's max) within 0.1 lr but for at most 1e-3 of
the elements (measured 9e-6 after the first step, 5e-4 after the
second). lr is 1e-6: Adam's first step is about lr * sign(g), and on
gradients within f32 noise of zero the two computations' signs differ,
so at lr 1e-3 such weights part by 2e-3 and the second step's fusion
targets change. Against JAX's sharded step: losses within rtol 1e-4
(the second step's fusion losses 1e-3: flax's one-pass batch variance),
and after the first step the statistics as above and optax's first
moment within 3e-2 relative L2.

Sharded inference against the one-process run on the global batch: the
same mask, boxes3d and probs within 1e-5. Not bit for bit: the CPU's
convs and products are not invariant to the batch size (a frame alone
and in a batch of two differ in the last bits, oneDNN on or off). For
int8 that difference moves activations across rounding boundaries, and
the moves compound with depth (tests/test_torch_quantized.py), so the
workers replay the one-process run's int8 activations (their own rows)
and keep their own scales: each scale must be the global batch's
(rtol 1e-5), which a shard's own amax is not.
"""

import dataclasses
import multiprocessing
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from __graft_entry__ import _tiny_config
from mv3d_tpu.models.mv3d_net import MV3DNet as JaxMV3DNet
from mv3d_tpu.models.nets import SUBNET_NAMES
from mv3d_tpu.parallel import mesh as jmesh
from mv3d_tpu.train.trainer import _prepare_views as jax_prepare_views
from mv3d_tpu_torch import convert
from mv3d_tpu_torch.data import loader as tloader
from mv3d_tpu_torch.train import trainer as ttrainer
from mv3d_tpu_torch.train.checkpoint import SubnetCheckpointer
from mv3d_tpu_torch.train.trainer import MV3D, Trainer

from test_torch_config import to_port_config
from test_torch_models import randomize_bn
from test_torch_train import _leaves, noise_from_key

torch.set_num_threads(2)

CFG = dataclasses.replace(_tiny_config(), model=dataclasses.replace(
    _tiny_config().model, compute_dtype="float32"))
QCFG = dataclasses.replace(CFG, model=dataclasses.replace(CFG.model,
                                                          quant="int8"))
PCFG, PQCFG = to_port_config(CFG), to_port_config(QCFG)
LR = 1e-6
# the RPN stage under a cosine schedule with one warmup step: the first
# step's learning rate is 0, the second's COS_LR
COS_CFG = dataclasses.replace(PCFG, train=dataclasses.replace(
    PCFG.train, lr_schedule="cosine", warmup_steps=1, decay_steps=3))
COS_LR = 1e-4
THRESH = 0.05
CHILD_TIMEOUT_S = 240


def _spawn(target, world, args, tmp):
    """Run ``target(rank, world, init, *args)`` in ``world`` spawned
    processes over a file-store gloo rendezvous; each is joined with its
    own timeout and killed past it. Raises if any child failed."""
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp}/rendezvous"
    procs = [ctx.Process(target=target, args=(r, world, init) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + CHILD_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.time(), 1.0))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"children {hung} hung past {CHILD_TIMEOUT_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"children exit codes {codes}"


def _save(out, rank, result):
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _load(out, world):
    res = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


# -- meshes: 4 processes ------------------------------------------------------

def _mesh_worker(rank, world, init, out):
    from mv3d_tpu_torch.parallel import mesh as pm
    pm.init_process_group("cpu", rank, world, init)
    batch = {"points": np.arange(8 * 3).reshape(8, 3), "tag": "x", "n": 3}
    res = {}
    for name, make in (("flat", lambda: pm.make_mesh(4)),
                       ("model2", lambda: pm.make_mesh(4, model_axis=2)),
                       ("hybrid", lambda: pm.make_hybrid_mesh(2))):
        mesh = make()
        res[name] = dict(
            names=mesh.mesh_dim_names, shape=tuple(mesh.mesh.shape),
            divisor=pm.batch_divisor(mesh),
            rows=pm.shard_batch(batch, mesh)["points"][:, 0].tolist(),
            group=torch.distributed.get_world_size(pm.batch_group(mesh)))
    for bad in (lambda: pm.make_mesh(3), lambda: pm.make_mesh(
            4, model_axis=3), lambda: pm.make_hybrid_mesh(3)):
        try:
            bad()
            res.setdefault("no_error", 0)
        except ValueError as e:
            res.setdefault("errors", []).append(str(e))
    torch.distributed.destroy_process_group()
    _save(out, rank, res)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("meshes")
    _spawn(_mesh_worker, 4, (str(tmp),), tmp)
    return _load(str(tmp), 4)


def test_mesh_shapes(meshes):
    for res in meshes:
        assert res["flat"]["names"] == ("data", "model")
        assert res["flat"]["shape"] == (4, 1)
        assert res["model2"]["shape"] == (2, 2)
        assert res["hybrid"]["names"] == ("dcn", "data", "model")
        assert res["hybrid"]["shape"] == (2, 2, 1)
        assert [res[k]["divisor"] for k in ("flat", "model2", "hybrid")] \
            == [4, 2, 4]
        assert [res[k]["group"] for k in ("flat", "model2", "hybrid")] \
            == [4, 2, 4]
        assert len(res["errors"]) == 3 and "no_error" not in res


def test_shard_batch_gives_each_rank_its_rows(meshes):
    """The flat and hybrid meshes split 8 frames 4 ways in rank order
    (dcn-major); with a model axis of 2 the two ranks of a data position
    hold the same 4 frames."""
    for rank, res in enumerate(meshes):
        two = [3 * (2 * rank + i) for i in range(2)]
        assert res["flat"]["rows"] == two
        assert res["hybrid"]["rows"] == two
        four = [3 * (4 * (rank // 2) + i) for i in range(4)]
        assert res["model2"]["rows"] == four


# -- the tiny model: 2 processes ----------------------------------------------

def _tiny_worker(rank, world, init, inputs_path, out):
    torch.set_num_threads(1)
    from mv3d_tpu_torch.models.nets import SUBNET_NAMES as NAMES
    from mv3d_tpu_torch.ops import quantized as tq
    from mv3d_tpu_torch.parallel import mesh as pm
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    pm.init_process_group("cpu", rank, world, init)
    mesh = pm.make_mesh()
    res = {}
    try:
        pm.shard_batch({"points": np.zeros((3, 5, 4))}, mesh)
    except ValueError as e:
        res["uneven"] = str(e)
    pm.check_batch_divisible({"n": 3, "tag": "x"}, mesh)

    tr = Trainer(None, cfg=inp["cfg"], device="cpu", lr=LR,
                 variables=inp["variables"],
                 checkpoint_dir=os.path.join(out, f"ck{rank}"),
                 log_dir=os.path.join(out, f"log{rank}"))
    pm.replicate(tr.model, mesh)
    step = pm.make_sharded_train_step(tr.model, tr.optimizer, NAMES, mesh,
                                      schedule=tr.schedule)
    shard = pm.shard_batch(inp["batch"], mesh)
    res["losses"], res["steps"] = [], []
    for noise in inp["noise"]:
        res["losses"].append(step(shard, noise))
        res["steps"].append(_train_state(tr))
    cos = Trainer(None, cfg=COS_CFG, device="cpu", lr=COS_LR,
                  variables=inp["variables"], train_targets=(NAMES[0],),
                  checkpoint_dir=os.path.join(out, f"cos_ck{rank}"),
                  log_dir=os.path.join(out, f"cos_log{rank}"))
    cos_step = pm.make_sharded_train_step(cos.model, cos.optimizer,
                                          cos.train_targets, mesh,
                                          schedule=cos.schedule)
    res["cosine"] = [(cos_step(shard, noise), _train_state(cos))
                     for noise in inp["noise"]]

    ck = SubnetCheckpointer("fusion", os.path.join(out, "dcp"),
                            backend="dcp")
    saved = tr.get_variables()["fusion"]
    ck.save(saved, step=2)
    res["dcp"] = (saved, ck.load())

    pts, num, rgb = (pm.shard_batch(inp["request"], mesh)[k]
                     for k in ("points", "num_points", "rgb"))
    model = MV3D(inp["cfg"], device="cpu", variables=inp["variables"]).model
    res["float"] = [x.numpy() for x in pm.make_sharded_infer_step(
        model, mesh, THRESH)(pts, rgb, num)]
    # int8 with the one-process run's activations replayed (this rank's
    # rows), each scale the port's own: global (MAX over the ranks), and
    # what this shard alone would give
    model = MV3D(inp["qcfg"], device="cpu", variables=inp["variables"]).model
    records, scales = iter(inp["int8_records"]), []
    real = tq.quantize_activation

    def replay(x, group=None):
        _, s_global = real(x, group)
        _, s_local = real(x)
        q, s_one = next(records)
        part = q.shape[0] // world
        scales.append((float(s_global), float(s_local), float(s_one)))
        return torch.from_numpy(q[rank * part:(rank + 1) * part]), s_global

    tq.quantize_activation = replay
    res["int8"] = [x.numpy() for x in pm.make_sharded_infer_step(
        model, mesh, THRESH)(pts, rgb, num)]
    tq.quantize_activation = real
    res["scales"] = scales
    torch.distributed.destroy_process_group()
    _save(out, rank, res)


def _train_state(tr):
    """A trainer's subnets' state dicts (torch layout) and Adam's step
    count and moments, by ``subnet.parameter``."""
    state = {f"{n}.{k}": v.numpy().copy()
             for n, m in tr.model.subnets.items()
             for k, v in m.state_dict().items()}
    adam = {}
    for name, module in tr.model.subnets.items():
        for pname, p in module.named_parameters():
            st = tr.optimizer.state.get(p)
            if st:
                adam[f"{name}.{pname}"] = {k: np.array(v) for k, v in
                                           st.items()}
    return dict(state=state, adam=adam)


@pytest.fixture(scope="module")
def inputs():
    drive = chip_smoke.SynthDrive(np.random.RandomState(2), PCFG, 2, 3000,
                                  cars=(2, 3))
    batch = tloader.frames_to_batch(drive.frames, PCFG)
    batch = {k: v for k, v in batch.items() if k != "tags"}
    variables = randomize_bn(jax.jit(JaxMV3DNet(CFG).init_variables)(
        jax.random.PRNGKey(0)), seed=3)
    keys = [jax.random.PRNGKey(11), jax.random.PRNGKey(12)]
    rng = np.random.RandomState(5)
    n = CFG.pipeline.max_points
    pts = np.stack([rng.uniform(0, 16, (2, n)), rng.uniform(-6, 6, (2, n)),
                    rng.uniform(-4, 0.8, (2, n)), rng.uniform(0, 1, (2, n))],
                   axis=-1).astype(np.float32)
    rgb = rng.rand(2, *CFG.rgb_shape).astype(np.float32)
    rgb[1] *= 8.0      # frames of different range: per-shard scales differ
    return dict(cfg=PCFG, qcfg=PQCFG, batch=batch, variables=variables,
                keys=keys, noise=[noise_from_key(k, 2, CFG) for k in keys],
                request=dict(points=pts, num_points=np.array(
                    [n, n - 300], np.int32), rgb=rgb))


@pytest.fixture(scope="module")
def unsharded(inputs):
    """``predict_from_points`` on the global batch, float and int8, with
    the int8 model's activations and scales recorded in order."""
    from mv3d_tpu_torch.ops import quantized as tq
    req = inputs["request"]
    out = {}
    for name, cfg in (("float", PCFG), ("int8", PQCFG)):
        model = MV3D(cfg, device="cpu", variables=inputs["variables"])
        with pytest.MonkeyPatch.context() as mp:
            records, real = [], tq.quantize_activation

            def record(x, group=None):
                q, s = real(x, group)
                records.append((q.numpy(), s.numpy()))
                return q, s

            mp.setattr(tq, "quantize_activation", record)
            out[name] = [x.numpy() for x in model.predict_from_points(
                req["points"], req["num_points"], req["rgb"], THRESH)]
        out[name + "_records"] = records
    return out


@pytest.fixture(scope="module")
def sharded(inputs, unsharded, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiny")
    path = os.path.join(str(tmp), "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict({k: v for k, v in inputs.items() if k != "keys"},
                         int8_records=unsharded["int8_records"]), f)
    _spawn(_tiny_worker, 2, (path, str(tmp)), tmp)
    return _load(str(tmp), 2), str(tmp)


@pytest.fixture(scope="module")
def one_process(inputs, tmp_path_factory):
    """The port's ``Trainer`` steps at the global batch, with JAX's draws
    in place of its generator's."""
    tmp = tmp_path_factory.mktemp("one")
    tr = Trainer(None, cfg=PCFG, device="cpu", lr=LR,
                 variables=inputs["variables"],
                 checkpoint_dir=str(tmp / "ck"), log_dir=str(tmp / "log"))
    draws = iter(inputs["noise"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrainer, "draw_noise", lambda cfg, b, gen, device=None: {
            k: torch.from_numpy(v).to(device) for k, v in next(draws).items()})
        losses, steps = [], []
        for _ in range(2):
            losses.append(tr.fit_iteration(inputs["batch"]))
            steps.append(_train_state(tr))
    return dict(losses=losses, steps=steps)


@pytest.fixture(scope="module")
def one_process_cosine(inputs, tmp_path_factory):
    """``Trainer``'s RPN-stage steps at the global batch under COS_CFG,
    with JAX's draws, and the initial state."""
    tmp = tmp_path_factory.mktemp("cos")
    tr = Trainer(None, cfg=COS_CFG, device="cpu", lr=COS_LR,
                 variables=inputs["variables"],
                 train_targets=(SUBNET_NAMES[0],),
                 checkpoint_dir=str(tmp / "ck"), log_dir=str(tmp / "log"))
    out = {"init": _train_state(tr)["state"]}
    draws = iter(inputs["noise"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrainer, "draw_noise", lambda cfg, b, gen, device=None: {
            k: torch.from_numpy(v).to(device) for k, v in next(draws).items()})
        out["steps"] = [(tr.fit_iteration(inputs["batch"]), _train_state(tr))
                        for _ in range(2)]
    return out


def test_uneven_batch_raises_clear_error(sharded):
    msg = sharded[0][0]["uneven"]
    assert "'points'" in msg and "divisible" in msg and "'data': 2" in msg


def _is_stat(key):
    return key.endswith(("running_mean", "running_var"))


def test_sharded_train_step_equals_one_process_step(sharded, one_process):
    """2 steps of every subnet at 2 x 1 frames over gloo == ``Trainer`` at
    B=2, after each step: losses, BatchNorm running statistics,
    parameters and Adam's moments; both ranks bit-equal."""
    (r0, r1), _ = sharded
    assert r0["losses"] == r1["losses"]
    for i in range(2):
        got, want = r0["steps"][i], one_process["steps"][i]
        for k, v in r1["steps"][i]["state"].items():
            np.testing.assert_array_equal(v, got["state"][k], err_msg=k)
        for k, w in one_process["losses"][i].items():
            np.testing.assert_allclose(r0["losses"][i][k], w, rtol=1e-5,
                                       err_msg=k)
        n_stats = n_params = n_apart = 0
        for k, w in want["state"].items():
            g = got["state"][k]
            if _is_stat(k):
                np.testing.assert_allclose(
                    g, w, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(w).max()),
                    err_msg=k)
                n_stats += 1
            elif k in want["adam"]:
                m = want["adam"][k]["exp_avg"]
                sure = np.abs(m) > 1e-3 * np.abs(m).max()
                apart = ~np.isclose(g, w, rtol=2.4e-7, atol=0.1 * LR)
                assert np.abs(g - w).max() <= 2.1 * (i + 1) * LR, k
                n_apart += (apart & sure).sum()
                n_params += sure.sum()
            elif not k.endswith("num_batches_tracked"):
                np.testing.assert_array_equal(g, w, err_msg=k)
        assert n_stats > 100 and n_params > 10000
        assert n_apart <= 1e-3 * n_params, (n_apart, n_params)
        assert got["adam"].keys() == want["adam"].keys()
        for k, st in want["adam"].items():
            assert int(got["adam"][k]["step"]) == int(st["step"]) == i + 1
            for m in ("exp_avg", "exp_avg_sq"):
                rel = (np.linalg.norm(got["adam"][k][m] - st[m])
                       / max(np.linalg.norm(st[m]), 1e-30))
                assert rel < 3e-2, (i, k, m, rel)


def test_sharded_train_step_follows_the_lr_schedule(sharded,
                                                    one_process_cosine):
    """The RPN stage under a cosine schedule with one warmup step, 2
    sharded steps at 2 x 1 frames against ``Trainer``'s at B=2: the first
    step (learning rate 0) moves no parameter, the second (COS_LR) moves
    them as ``Trainer``'s does. After each step: losses rtol 1e-5, Adam's
    step count and moments within 1e-4 relative L2 (the RPN's gradients
    do not reach through the fusion head), and where the gradient's sign
    is sure the parameters within 0.1 COS_LR of ``Trainer``'s."""
    (r0, r1), _ = sharded
    init = one_process_cosine["init"]
    for i, ((gl, got), (wl, want)) in enumerate(zip(
            r0["cosine"], one_process_cosine["steps"])):
        assert r1["cosine"][i][0] == gl
        for k, w in wl.items():
            np.testing.assert_allclose(gl[k], w, rtol=1e-5, err_msg=k)
        assert want["adam"].keys() == got["adam"].keys()
        assert all(k.startswith(SUBNET_NAMES[0] + ".") for k in want["adam"])
        n_sure = n_moved = 0
        for k, st in want["adam"].items():
            assert int(got["adam"][k]["step"]) == int(st["step"]) == i + 1
            for m in ("exp_avg", "exp_avg_sq"):
                rel = (np.linalg.norm(got["adam"][k][m] - st[m])
                       / max(np.linalg.norm(st[m]), 1e-30))
                assert rel < 1e-4, (i, k, m, rel)
            g, w = got["state"][k], want["state"][k]
            if i == 0:
                np.testing.assert_array_equal(g, init[k], err_msg=k)
                np.testing.assert_array_equal(w, init[k], err_msg=k)
                continue
            m = st["exp_avg"]
            sure = np.abs(m) > 1e-3 * np.abs(m).max()
            np.testing.assert_allclose(g[sure], w[sure], rtol=2.4e-7,
                                       atol=0.1 * COS_LR, err_msg=k)
            n_moved += (np.abs(w - init[k])[sure] > 0.5 * COS_LR).sum()
            n_sure += sure.sum()
        if i:
            assert n_sure > 1000 and n_moved > 0.9 * n_sure


def test_sharded_train_step_matches_jax(inputs, sharded):
    """The same 2 steps through JAX's ``make_sharded_train_step`` on a
    2-device mesh (optax Adam, the same keys)."""
    (r0, _), _ = sharded
    jm = JaxMV3DNet(CFG)
    mesh = jmesh.make_mesh(2)
    views = jax_prepare_views({k: jnp.asarray(v) for k, v in
                               inputs["batch"].items()}, CFG)
    # JAX's sharded step takes no occupancy: its anchor filter sums the
    # view's channels, the same mask at remove_empty_thresh 0
    assert CFG.pipeline.remove_empty_thresh == 0
    for k in ("points", "num_points", "top_occ"):
        views.pop(k)
    batch = jmesh.shard_batch(views, mesh)
    optimizer = optax.adam(LR)
    variables = jmesh.replicate(jax.tree.map(jnp.asarray,
                                             inputs["variables"]), mesh)
    params = {n: variables[n]["params"] for n in SUBNET_NAMES}
    opt_state = jmesh.replicate(optimizer.init(params), mesh)
    step = jmesh.make_sharded_train_step(jm, optimizer, SUBNET_NAMES, mesh,
                                         CFG)
    for i, (key, got) in enumerate(zip(inputs["keys"], r0["losses"])):
        variables, opt_state, losses = step(variables, opt_state, batch, key)
        for k, w in losses.items():
            np.testing.assert_allclose(got[k], float(w),
                                       rtol=1e-3 if i and k.startswith(
                                           "fuse") else 1e-4, err_msg=k)
        if i == 0:
            _check_first_moment(opt_state[0].mu, r0["steps"][0]["adam"])
            _check_stats(variables, r0["steps"][0]["state"])


def _check_stats(variables, state):
    """flax's BatchNorm statistics against the port's, rtol 1e-4 and atol
    1e-5 of each tensor's magnitude (at least 1)."""
    n = 0
    for name in SUBNET_NAMES:
        stats = convert.subnet_state_dict(jax.tree.map(
            np.asarray, {"batch_stats": variables[name]["batch_stats"]}))
        for k, w in stats.items():
            if _is_stat(k):
                w = w.numpy()
                np.testing.assert_allclose(
                    state[f"{name}.{k}"], w, rtol=1e-4,
                    atol=1e-5 * max(1.0, np.abs(w).max()),
                    err_msg=f"{name}.{k}")
                n += 1
    assert n > 100


def _check_first_moment(mu, adam):
    """optax's first moment after one step against torch Adam's, per
    tensor within 3e-2 relative L2 (the full net's gradient tolerance of
    tests/test_torch_train.py)."""
    mu = jax.tree.map(np.asarray, mu)
    n = 0
    for name in SUBNET_NAMES:
        for k, w in convert.subnet_state_dict({"params": mu[name]}).items():
            w = w.numpy()
            if not np.abs(w).max():
                continue
            got = adam[f"{name}.{k}"]["exp_avg"]
            rel = np.linalg.norm(got - w) / np.linalg.norm(w)
            assert rel < 3e-2, (name, k, rel)
            n += 1
    assert n > 150


def test_sharded_inference_equals_unsharded(unsharded, sharded):
    """Each rank's ``make_sharded_infer_step`` returns the global batch's
    detections, those of ``predict_from_points`` on the whole batch: the
    same mask, boxes3d and probs within 1e-5 (float and int8)."""
    (r0, r1), _ = sharded
    for name in ("float", "int8"):
        boxes, probs, mask = unsharded[name]
        assert mask.sum() >= 2
        for res in (r0, r1):
            np.testing.assert_array_equal(res[name][2], mask)
            np.testing.assert_allclose(res[name][0][mask], boxes[mask],
                                       rtol=0, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(res[name][1][mask], probs[mask],
                                       rtol=0, atol=1e-5, err_msg=name)


def test_int8_scales_are_global_over_the_mesh(sharded):
    """Every int8 layer's activation scale on each rank is the global
    batch's (within rtol 1e-5 of the one-process scale), where the
    shard's own scale would differ: frame 1's rgb is 8x frame 0's, so on
    rank 0 the rgb trunk's scales fall by far more."""
    (r0, r1), _ = sharded
    for res in (r0, r1):
        s = np.array(res["scales"])
        np.testing.assert_allclose(s[:, 0], s[:, 2], rtol=1e-5)
    s = np.array(r0["scales"])
    assert (s[:, 1] < 0.5 * s[:, 2]).sum() >= 5


def test_dcp_checkpoint_round_trip(sharded, tmp_path):
    """Both ranks saved the trained fusion subnet as one ``"dcp"``
    checkpoint and loaded it back bit-equal; one process without a group
    restores it bit-equal too. ``"orbax"`` is refused, naming ``"dcp"``."""
    (r0, r1), tmp = sharded
    want = dict(_leaves(r0["dcp"][0]))
    assert len(want) > 50
    for res in (r0, r1):
        got = dict(_leaves(res["dcp"][1]))
        assert got.keys() == want.keys()
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    ck = SubnetCheckpointer("fusion", os.path.join(tmp, "dcp"),
                            backend="dcp")
    assert ck.latest_step() == 2
    for k, v in _leaves(ck.load()):
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    with pytest.raises(ValueError, match="dcp"):
        SubnetCheckpointer("fusion", str(tmp_path), backend="orbax")
    with pytest.raises(ValueError, match="dcp"):
        MV3D(PCFG, device="cpu", checkpoint_dir=str(tmp_path),
             checkpoint_backend="orbax")
