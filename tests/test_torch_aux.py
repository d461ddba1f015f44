"""The port's auxiliary modules against the JAX package's: tracking
(``tracking/{ukf,tracker,seq_model}.py``), the cost model
(``utils/macs.py``) and the profiling helpers (``utils/profiling.py``);
the counterparts of ``tests/test_aux.py:17-67`` and :123.

Tolerances. The UKF and the tracker are numpy copies: their state equals
JAX's bit for bit after every step. ``MotionGRU`` on weights converted
from flax (``convert.motion_gru_state_dict``) within atol 1e-5 of flax's
forward; 20 Adam steps from those weights track optax's losses within
1e-4 relative. The parameter counts are exact; torch's GRU holds
``2 * hidden`` more parameters than flax's (``b_hr`` and ``b_hz``, which
flax does not have; converted weights hold them at 0).

FLOPs: ``FlopCounterMode`` counts the convolutions and matmuls alone,
XLA's ``cost_analysis`` every op, so the two differ; on the tiny top-view
RPN trunk (B=1, 80 x 60 x 27) the port counts 505,651,200 FLOPs and
XLA 480,947,584, a ratio of 1.0514 (this test prints it); the test holds
the ratio within 0.5-2.

Wall time about 25 s on the CPU (one JAX compile of the trunk, a few of
the GRU).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from mv3d_tpu.models.mv3d_net import MV3DNet as JaxMV3DNet
from mv3d_tpu.tracking import MultiObjectTracker as JaxTracker
from mv3d_tpu.tracking import UnscentedKalmanFilter as JaxUKF
from mv3d_tpu.tracking.seq_model import MotionGRU as JaxMotionGRU
from mv3d_tpu.tracking.seq_model import SeqMotionTracker as JaxSeqTracker
from mv3d_tpu.utils import macs as jmacs
from mv3d_tpu.utils import profiling as jprofiling
from mv3d_tpu_torch import convert
from mv3d_tpu_torch.models.mv3d_net import MV3DNet
from mv3d_tpu_torch.tracking import MultiObjectTracker, UnscentedKalmanFilter
from mv3d_tpu_torch.tracking.seq_model import MotionGRU, SeqMotionTracker
from mv3d_tpu_torch.utils import macs, profiling

from test_torch_config import to_port_config

torch.set_num_threads(2)

CFG = dataclasses.replace(_tiny_config(), model=dataclasses.replace(
    _tiny_config().model, compute_dtype="float32"))
PCFG = to_port_config(CFG)


def _same_ukf(a, b):
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.P, b.P)


def test_ukf_tracks_constant_velocity():
    ukf, ref = UnscentedKalmanFilter(), JaxUKF()
    rng = np.random.RandomState(0)
    for i in range(30):
        z = np.array([i * 1.0, 5.0]) + rng.normal(0, 0.1, 2)
        assert ukf.step(z, dt=0.1) == ref.step(z, dt=0.1)
        _same_ukf(ukf, ref)
    assert abs(ukf.x[0] - 29.0) < 0.5
    assert abs(ukf.x[1] - 5.0) < 0.3
    assert abs(ukf.x[2] - 10.0) < 1.5
    assert abs(ukf.x[3]) < 0.2


def test_ukf_turning():
    ukf, ref = UnscentedKalmanFilter(), JaxUKF()
    dt, v, yawd = 0.1, 8.0, 0.3
    yaw, px, py = 0.0, 0.0, 0.0
    for _ in range(50):
        px += v * dt * np.cos(yaw)
        py += v * dt * np.sin(yaw)
        yaw += yawd * dt
        ukf.step(np.array([px, py]), dt=dt)
        ref.step(np.array([px, py]), dt=dt)
        _same_ukf(ukf, ref)
    assert np.linalg.norm(ukf.x[0:2] - [px, py]) < 0.5
    assert abs(ukf.x[4] - yawd) < 0.15


def _same_tracks(got, want):
    assert [t.track_id for t in got] == [t.track_id for t in want]
    for a, b in zip(got, want):
        assert (a.hits, a.missed, a.yaw) == (b.hits, b.missed, b.yaw)
        np.testing.assert_array_equal(a.size, b.size)
        np.testing.assert_array_equal(np.asarray(a.history),
                                      np.asarray(b.history))
        _same_ukf(a.ukf, b.ukf)


def test_tracker_association():
    tr, ref = MultiObjectTracker(dt=0.1, min_hits=2), JaxTracker(
        dt=0.1, min_hits=2)
    for i in range(6):
        dets = np.array([[10.0 + i * 0.5, 2.0, -1.0],
                         [30.0, -5.0 - i * 0.5, -1.0]])
        sizes = np.tile([1.5, 1.6, 4.0], (2, 1))
        yaws = np.zeros(2)
        confirmed = tr.update(dets, sizes, yaws)
        _same_tracks(confirmed, ref.update(dets, sizes, yaws))
        _same_tracks(tr.tracks, ref.tracks)
    assert len(confirmed) == 2
    assert sorted(t.track_id for t in confirmed) == [0, 1]
    assert all(t.hits == 6 for t in confirmed)


def test_tracker_drops_stale():
    tr, ref = (cls(dt=0.1, max_missed=2, min_hits=1)
               for cls in (MultiObjectTracker, JaxTracker))
    for t in (tr, ref):
        t.update(np.array([[5.0, 0.0, 0.0]]), np.array([[1.5, 1.6, 4.0]]),
                 np.zeros(1))
    _same_tracks(tr.tracks, ref.tracks)
    for _ in range(4):
        for t in (tr, ref):
            t.update(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
        _same_tracks(tr.tracks, ref.tracks)
    assert len(tr.tracks) == 0


def _tracks(seed=0, b=16, t=10):
    rng = np.random.RandomState(seed)
    v = rng.uniform(-1, 1, (b, 1, 3))
    steps = np.arange(t).reshape(1, t, 1)
    return (v * steps + rng.normal(0, 0.01, (b, t, 3))).astype(np.float32)


def test_motion_gru_matches_flax_on_converted_weights():
    model = JaxMotionGRU(hidden=8)
    deltas = np.diff(_tracks(1, b=4, t=7), axis=1)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 4, 3)))
    # nonzero biases, so the bias mapping is exercised too
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * np.random.RandomState(
            a.size).normal(size=a.shape).astype(np.float32), params)
    want = np.asarray(model.apply(params, deltas))
    port = MotionGRU(hidden=8)
    port.load_state_dict(convert.motion_gru_state_dict(params))
    with torch.no_grad():
        got = port(torch.from_numpy(deltas)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # torch's b_hr/b_hz: 2 * hidden parameters flax does not have
    assert macs.count_params(port) == jmacs.count_params(params) + 2 * 8


def test_fit_tracks_optax_from_converted_weights():
    tracks = _tracks(2, b=8)
    ref = JaxSeqTracker(hidden=16, lr=5e-3, seed=1)
    port = SeqMotionTracker(hidden=16, lr=5e-3, device="cpu")
    port.model.load_state_dict(convert.motion_gru_state_dict(ref.params))
    for step in range(20):
        want, got = ref.fit(tracks, steps=1), port.fit(tracks, steps=1)
        assert got == pytest.approx(want, rel=1e-4), step
    np.testing.assert_allclose(port.predict_next(tracks[:, :-1]),
                               ref.predict_next(tracks[:, :-1]),
                               rtol=0, atol=1e-4)


def test_seq_motion_tracker_learns():
    tracks = _tracks(0)
    tr = SeqMotionTracker(hidden=32, lr=5e-3, device="cpu")
    loss = tr.fit(tracks, steps=300)
    assert loss < 0.05
    pred = tr.predict_next(tracks[:, :-1])
    err = np.linalg.norm(pred - tracks[:, -1], axis=1)
    assert err.mean() < 0.35, err.mean()


def test_seq_motion_tracker_is_seeded():
    a, b = (SeqMotionTracker(hidden=8, seed=5, device="cpu")
            for _ in range(2))
    for x, y in zip(a.model.state_dict().values(),
                    b.model.state_dict().values()):
        assert torch.equal(x, y)


def test_count_params():
    tree = {"a": np.zeros((3, 4)), "b": {"c": np.zeros(7)}}
    assert macs.count_params(tree) == jmacs.count_params(tree) == 19


def test_count_params_excludes_buffers():
    bn = torch.nn.BatchNorm2d(4)
    assert macs.count_params(bn) == 8      # running stats are buffers


@pytest.fixture(scope="module")
def jax_shapes():
    """The tiny JAX model's variable shapes (no compile)."""
    model = JaxMV3DNet(CFG)
    return model, jax.eval_shape(model.init_variables, jax.random.PRNGKey(0))


def test_param_breakdown_matches_jax(jax_shapes):
    _, shapes = jax_shapes
    want = jmacs.param_breakdown(shapes)
    model = MV3DNet(PCFG)
    assert macs.param_breakdown(model) == want
    assert macs.param_breakdown(model.subnets) == want
    # and on flax-shaped variables themselves
    assert macs.param_breakdown(shapes) == want


def test_flops_of_trunk_against_xla(jax_shapes, tmp_path, capsys):
    jm, shapes = jax_shapes
    variables = jax.jit(jm.init_variables)(jax.random.PRNGKey(0))
    top = np.random.RandomState(0).rand(1, *CFG.top_shape).astype(np.float32)
    want = jmacs.flops_of(lambda v, a: jm.top_rpn.apply(v, a, False),
                          variables["top_view_rpn"], top)
    model = MV3DNet(PCFG)
    convert.load_variables(model, jax.tree.map(np.asarray, variables))
    trunk = model.subnets["top_view_rpn"].eval()
    with torch.no_grad():
        got = macs.flops_of(trunk, torch.from_numpy(top))
    assert got is not None and want is not None and got > 0
    with capsys.disabled():
        print(f"\nflops_of top_view_rpn tiny B=1: port {got:,.0f}, XLA "
              f"{want:,.0f}, ratio {got / want:.4f}")
    assert 0.5 < got / want < 2.0
    assert macs.flops_of(lambda: 1 / 0) is None

    with torch.no_grad():
        text = macs.print_macs_to_file(trunk, (torch.from_numpy(top),),
                                       model, str(tmp_path / "macs.txt"))
    lines = text.splitlines()
    assert lines[:2] == ["MV3D TPU cost report", "=" * 40]
    # the subnets in the port's order, JAX's counts
    assert sorted(lines[2:-1]) == sorted(
        f"params[{k}]: {n:,}" for k, n in
        jmacs.param_breakdown(shapes).items())
    assert lines[-1] == f"compiled flops (one step): {got:,.0f}"
    assert (tmp_path / "macs.txt").read_text() == text


def test_step_timer_summary_matches_jax():
    times = [0.5, 0.125, 0.25, 0.375, 1.0, 0.0625]
    port, ref = profiling.StepTimer(), jprofiling.StepTimer()
    for t in times:
        port.record(t)
        ref.record(t)
    for skip in (0, 1, 10):
        assert port.summary(skip) == ref.summary(skip)
    with port.step(torch.zeros(2)):
        pass
    assert len(port.times) == len(times) + 1


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "profile")
    with profiling.trace(log_dir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(prof.trace_path) == log_dir
    assert os.path.getsize(prof.trace_path) > 0
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names
