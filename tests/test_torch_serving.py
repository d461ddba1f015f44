"""The port's serving entry point (``mv3d_tpu_torch.serving``,
``mv3d_tpu_torch.cli.{export,serve}``) against ``tests/test_export.py``'s
contract and the JAX package, on the tiny config with
``voxel_order="pallas-sort"`` (every call sorts its points with K4's plain
network before the sweep) and f32 compute.

Tolerances: the port's artifact against its own in-process calls is
bit-exact; against JAX ``build_serving_fn`` with the same weights the
detection mask is exact, boxes3d within atol 1e-3 and probs within 1e-4
on live slots (those of tests/test_torch_slice.py); the quantized point
transfer is bit-exact against JAX's.
"""

import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from mv3d_tpu.models.mv3d_net import MV3DNet as JaxMV3DNet
from mv3d_tpu.ops import quantize as jquant
from mv3d_tpu.serving import build_serving_fn as jax_build_serving_fn
from mv3d_tpu.serving.export import _flatten as jax_flatten
from mv3d_tpu_torch import kitti_config, serving_config
from mv3d_tpu_torch.cli import export as cli_export
from mv3d_tpu_torch.cli.serve import make_server
from mv3d_tpu_torch.ops import quantize as tquant
from mv3d_tpu_torch.serving import (ServingModel, build_serving_fn,
                                    export_serving, load_serving)
from mv3d_tpu_torch.serving.export import config_from_dict
from mv3d_tpu_torch.train.trainer import MV3D, Predictor

from test_torch_config import to_port_config
from test_torch_models import randomize_bn

torch.set_num_threads(2)

CFG = dataclasses.replace(
    _tiny_config(),
    model=dataclasses.replace(_tiny_config().model, compute_dtype="float32"),
    pipeline=dataclasses.replace(_tiny_config().pipeline,
                                 use_pallas_fused=True,
                                 voxel_order="pallas-sort"))
PCFG = to_port_config(CFG)
THRESH = 0.05


def _inputs(b=1, seed=0):
    """Clouds over the tiny grid (as tests/test_export.py draws them) with
    a short last frame when b > 1, and random rgb."""
    rng = np.random.RandomState(seed)
    n = CFG.pipeline.max_points
    pts = np.stack([rng.uniform(0, 16, (b, n)), rng.uniform(-6, 6, (b, n)),
                    rng.uniform(-4, 0.8, (b, n)), rng.uniform(0, 1, (b, n))],
                   axis=-1).astype(np.float32)
    num = np.full((b,), n, np.int32)
    if b > 1:
        num[-1] = n - 300
        pts[-1, n - 300:] = -1e9
    rgb = rng.rand(b, *CFG.rgb_shape).astype(np.float32)
    return pts, num, rgb


@pytest.fixture(scope="module")
def jax_variables():
    return randomize_bn(jax.jit(JaxMV3DNet(CFG).init_variables)(
        jax.random.PRNGKey(0)), seed=5)


@pytest.fixture(scope="module")
def model(jax_variables):
    return MV3D(PCFG, device="cpu", variables=jax_variables)


@pytest.fixture(scope="module")
def artifact(model, tmp_path_factory):
    """A batch-2 artifact of the port's weights."""
    return export_serving(model.get_variables(), PCFG,
                          str(tmp_path_factory.mktemp("art") / "b2"),
                          batch_size=2, score_threshold=THRESH)


def test_export_roundtrip_bitexact(model, artifact):
    """export -> load -> call == ``MV3D.predict_from_points``, bit for bit;
    the meta fields and the configuration survive."""
    served = load_serving(artifact, device="cpu")
    pts, num, rgb = _inputs(b=2)
    got = served(pts, num, rgb)
    want = model.predict_from_points(pts, num, rgb, THRESH)
    assert want.mask.any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert got[2].dtype == bool
    meta = served.meta
    assert meta["batch_size"] == 2 and not meta["quantized"]
    assert meta["input_names"] == ["points", "num_points", "rgb"]
    assert meta["output_names"] == ["boxes3d", "probs", "mask"]
    assert meta["max_points"] == 2048 and meta["rgb_shape"] == [64, 96, 3]
    assert meta["score_threshold"] == THRESH
    assert meta["torch_version"] == torch.__version__
    assert served.cfg == PCFG


@pytest.mark.parametrize("name", ["tiny", "serving"])
def test_config_json_round_trip(name):
    """config.json restores the exact config: tuple fields come back as
    tuples (nested ones too), floats bit for bit."""
    cfg = PCFG if name == "tiny" else serving_config(kitti_config())
    d = json.loads(json.dumps(dataclasses.asdict(cfg)))
    assert config_from_dict(d) == cfg
    with pytest.raises(KeyError, match="unknown"):
        config_from_dict({**d, "bogus": 1})


def test_detections_match_jax_serving_fn(jax_variables, artifact):
    """The port's artifact against JAX ``build_serving_fn`` (K4 and the
    sweep in interpret mode) with the same weights."""
    served = load_serving(artifact, device="cpu")
    pts, num, rgb = _inputs(b=2, seed=1)
    fn, _ = jax_build_serving_fn(CFG, score_threshold=THRESH)
    want = [np.asarray(x) for x in jax.jit(fn)(jax_variables, pts, num, rgb)]
    boxes, probs, mask = served(pts, num, rgb)
    assert want[2].sum() >= 1
    np.testing.assert_array_equal(mask, want[2])
    np.testing.assert_allclose(boxes[mask], want[0][mask], rtol=0, atol=1e-3)
    np.testing.assert_allclose(probs[mask], want[1][mask], rtol=0, atol=1e-4)


def test_predict_pads_and_checks_the_batch(artifact):
    """predict() on a batch-2 artifact pads a ragged cloud with an empty
    frame; predict_batch runs two frames in one call with the same
    per-frame answers, and refuses more frames than the batch."""
    served = load_serving(artifact, device="cpu")
    pts, _, rgb = _inputs(b=2, seed=3)
    ragged = pts[0][: CFG.pipeline.max_points // 2]
    b_r, p_r = served.predict(ragged, rgb[0])
    assert b_r.ndim == 3 and b_r.shape[1:] == (8, 3)
    assert p_r.shape == (b_r.shape[0],) and np.isfinite(b_r).all()
    b0, p0 = served.predict(pts[0], rgb[0])
    both = served.predict_batch([(pts[0], rgb[0]), (pts[1], rgb[1])])
    assert len(both) == 2 and len(b0) > 0
    np.testing.assert_array_equal(both[0][0], b0)
    np.testing.assert_array_equal(both[0][1], p0)
    with pytest.raises(ValueError, match="batch"):
        served.predict_batch([(pts[0], rgb[0])] * 3)


def test_quantize_points_match_jax():
    """Host quantization and device dequantization bit-equal to JAX's
    eager functions and to numpy's multiply-then-add, padding rows
    included. Jitted on the CPU, XLA contracts JAX's ``q * scale + lo``
    into one fused multiply-add, which skips the product's rounding:
    within atol 4e-6, two ulps of the largest product (|x| < 16.3 m)."""
    pts, _, _ = _inputs(b=2, seed=4)
    q, r = tquant.quantize_points(pts, PCFG)
    jq, jr = jquant.quantize_points(pts, CFG)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(r, jr)
    assert q.dtype == np.uint16 and r.dtype == np.uint8
    got = tquant.dequantize_points(torch.from_numpy(q), torch.from_numpy(r),
                                   PCFG).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jquant.dequantize_points(q, r, CFG)))
    lo, hi = tquant._bounds(PCFG)
    np.testing.assert_array_equal(
        got[..., :3], q.astype(np.float32) * ((hi - lo) / tquant.QMAX) + lo)
    np.testing.assert_allclose(got, np.asarray(jax.jit(
        jquant.dequantize_points, static_argnums=2)(q, r, CFG)), rtol=0,
        atol=4e-6)
    lo, hi = tquant._bounds(PCFG)
    jlo, jhi = jquant._bounds(CFG)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)


def test_quantized_artifact(model, tmp_path):
    """The quantized artifact takes the uint16/uint8 pair and equals the
    in-process quantized call bit for bit; predict() quantizes from the
    grid in meta.json alone."""
    out = export_serving(model.get_variables(), PCFG, str(tmp_path / "q"),
                         batch_size=1, quantized=True)
    served = load_serving(out, device="cpu")
    pts, num, rgb = _inputs(b=1, seed=2)
    q, r = tquant.quantize_points(pts, PCFG)
    got = served(q, r, num, rgb)
    fn, specs = build_serving_fn(PCFG, quantized=True)
    want = fn(model, q, r, num, rgb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert [s for s, _ in specs(1)] == [a.shape for a in (q, r, num, rgb)]
    assert [d for _, d in specs(1)] == [a.dtype for a in (q, r, num, rgb)]
    lo, hi = tquant._bounds(PCFG)
    assert served.meta["quant_bounds"] == {"lo": lo.tolist(),
                                           "hi": hi.tolist()}
    assert served.meta["input_names"] == ["points_q", "refl_q", "num_points",
                                          "rgb"]
    boxes3d, probs = served.predict(pts[0], rgb[0])
    keep = got[2][0]
    assert keep.any()
    np.testing.assert_array_equal(boxes3d, got[0][0][keep])
    np.testing.assert_array_equal(probs, got[1][0][keep])


def test_weights_npz_is_the_jax_flatten(jax_variables, artifact):
    """weights.npz holds JAX ``_flatten`` of the same variables: the same
    keys and the same (HWIO/flax) arrays."""
    want = jax_flatten(jax.tree.map(np.asarray, jax_variables))
    with np.load(f"{artifact}/weights.npz") as z:
        assert sorted(z.files) == sorted(want)
        for k in z.files:
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)


def test_cli_export_random_init(tmp_path):
    """python -m mv3d_tpu_torch.cli.export --random-init on the tiny
    config from an override file and --set."""
    from test_cli_mains import TINY_OVERRIDES
    overrides = tmp_path / "tiny.json"
    overrides.write_text(json.dumps(TINY_OVERRIDES))
    out = cli_export.main([
        "--random-init", "--out", str(tmp_path / "cli_art"),
        "--config", str(overrides), "--set", "pipeline.voxel_order",
        "pallas-sort", "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--batch-size", "2", "--device", "cpu"])
    served = load_serving(out, device="cpu")
    assert served.meta["batch_size"] == 2
    assert served.cfg.pipeline.voxel_order == "pallas-sort"
    assert served.cfg.top_shape == PCFG.top_shape
    pts, num, rgb = _inputs(b=2, seed=4)
    boxes, probs, mask = served(pts, num, rgb)
    assert boxes.shape == (2, 16, 8, 3) and mask.dtype == bool


def test_predictor_loads_every_checkpoint(model, tmp_path):
    """``Predictor`` restores all subnets of its tag on construction."""
    kw = dict(log_tag="t", checkpoint_dir=str(tmp_path / "ckpt"),
              log_dir=str(tmp_path / "log"), device="cpu")
    MV3D(PCFG, variables=model.get_variables(), **kw).save_weights()
    pred = Predictor(PCFG, seed=7, **kw)
    fresh = MV3D(PCFG, seed=7, device="cpu").get_variables()
    got, want = (jax_flatten(v) for v in (pred.get_variables(),
                                          model.get_variables()))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert any(not np.array_equal(got[k], v)
               for k, v in jax_flatten(fresh).items())


def test_entry_points_default_to_the_card(artifact, monkeypatch, tmp_path):
    """Without CUDA, loading, serving and exporting without a device raise;
    an int8 artifact exports (it is the float weights and a config) and
    its loading raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_serving(artifact)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_server(artifact, port=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_export.main(["--random-init", "--out", str(tmp_path / "x")])
    int8 = dataclasses.replace(PCFG, model=dataclasses.replace(
        PCFG.model, quant="int8"))
    art = export_serving({}, int8, str(tmp_path / "i8"))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_serving(art)


def _post(port, body, accept=None, timeout=120):
    headers = {"Accept": accept} if accept else {}
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=body, method="POST", headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


@pytest.fixture
def server(model, tmp_path):
    """Start ``make_server`` over an artifact of the port's weights (batch
    size and threshold from the test's parameters) in a thread."""
    running = []

    def start(batch_size, score_threshold=0.0):
        out = export_serving(model.get_variables(), PCFG,
                             str(tmp_path / f"art{batch_size}"),
                             batch_size=batch_size,
                             score_threshold=score_threshold)
        srv = make_server(out, port=0, device="cpu")
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        running.append(srv)
        return srv.server_address[1], load_serving(out, device="cpu")

    yield start
    for srv in running:
        srv.shutdown()
        srv.server_close()


def test_serve_http_endpoint(server):
    """healthz returns the meta; POST /predict (npz body) equals the
    in-process predict() exactly, as npz and as JSON; a malformed body
    gets 400 with its cause; an unknown path 404."""
    port, served = server(1)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=30) as r:
        meta = json.loads(r.read())
    assert meta["status"] == "ok" and meta["batch_size"] == 1
    assert meta["torch_version"] == torch.__version__

    pts, _, rgb = _inputs(b=1)
    want_boxes, want_probs = served.predict(pts[0], rgb[0])
    assert len(want_boxes) > 0
    body = _npz(points=pts[0], rgb=rgb[0])
    with np.load(io.BytesIO(_post(port, body))) as z:
        np.testing.assert_array_equal(z["boxes3d"], want_boxes)
        np.testing.assert_array_equal(z["probs"], want_probs)
    got = json.loads(_post(port, body, accept="application/json"))
    np.testing.assert_array_equal(np.asarray(got["boxes3d"], np.float32),
                                  want_boxes)
    np.testing.assert_array_equal(np.asarray(got["probs"], np.float32),
                                  want_probs)
    for bad in (b"not-an-npz", _npz(points=pts[0])):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, bad, timeout=30)
        assert e.value.code == 400 and "error" in json.loads(e.value.read())
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
    assert e.value.code == 404


def test_server_runs_every_request_on_one_model_thread(artifact,
                                                      monkeypatch):
    """Requests arrive on a new handler thread each, but every execution
    runs on the server's one model thread (PyTorch's per-thread CUDA
    state is set up once); the thread ends with ``server_close``."""
    seen = []
    predict_batch = ServingModel.predict_batch

    def spy(self, frames):
        seen.append(threading.current_thread())
        return predict_batch(self, frames)

    monkeypatch.setattr(ServingModel, "predict_batch", spy)
    srv = make_server(artifact, port=0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    pts, _, rgb = _inputs(b=1, seed=5)
    body = _npz(points=pts[0], rgb=rgb[0])
    try:
        for _ in range(3):
            _post(srv.server_address[1], body)
    finally:
        srv.shutdown()
        srv.server_close()
    assert len(seen) == 3 and len(set(seen)) == 1
    assert seen[0] is not threading.current_thread()
    assert seen[0].name.startswith("mv3d-model")
    seen[0].join(timeout=30)
    assert not seen[0].is_alive()


def test_serve_batched_artifact_and_concurrency(server):
    """A batch-2 artifact serves stacked requests (points_i/rgb_i in,
    boxes3d_i/probs_i out, or a JSON ``frames`` list) equal to
    predict_batch, and six concurrent single-frame clients all get the
    padded single-frame answer."""
    port, served = server(2)
    pts, _, rgb = _inputs(b=2, seed=3)
    both = served.predict_batch([(pts[0], rgb[0]), (pts[1], rgb[1])])
    body = _npz(points_0=pts[0], rgb_0=rgb[0], points_1=pts[1], rgb_1=rgb[1])
    with np.load(io.BytesIO(_post(port, body))) as z:
        for i in range(2):
            np.testing.assert_array_equal(z[f"boxes3d_{i}"], both[i][0])
            np.testing.assert_array_equal(z[f"probs_{i}"], both[i][1])
    frames = json.loads(_post(port, body, accept="application/json"))
    assert len(frames["frames"]) == 2
    np.testing.assert_array_equal(
        np.asarray(frames["frames"][1]["probs"], np.float32), both[1][1])

    b0, p0 = served.predict(pts[0], rgb[0])
    single = _npz(points=pts[0], rgb=rgb[0])
    results, errors = [None] * 6, []

    def client(i):
        try:
            with np.load(io.BytesIO(_post(port, single, timeout=180))) as z:
                results[i] = (z["boxes3d"], z["probs"])
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    for bx, pr in results:
        np.testing.assert_array_equal(bx, b0)
        np.testing.assert_array_equal(pr, p0)
