"""The frozen serving program (``mv3d_tpu_torch.serving``: a
``torch.export`` program with the kernels as ``mv3d::`` operators) against
the port's eager call and the JAX package's exported artifact
(``mv3d_tpu.serving.export_serving`` + ``load_serving``), on the tiny
config with f32 compute, on the CPU.

Configurations: ``hwc`` (K1 at ``use_pallas_fused``), ``s2d2p`` (K2),
``pallas-sort`` (K4 + K1) and ``quantized`` (the uint16/uint8 transfer, at
pallas-sort); ``int8`` (``model.quant="int8"``, hwc) is
tests/test_torch_frozen_int8.py, on these helpers.

  * Each exported graph names its ``mv3d::`` operators and none of the
    plain versions' signature ops: no ``scatter_reduce`` or
    ``index_add`` (the plain sweeps and scatter-max), no ``argsort`` (the
    radix twin's digit passes; the model's own sorts are
    ``aten.sort.stable``) and no ``searchsorted`` (the merge twin); it
    holds one ``mv3d::bn_relu`` per BatchNorm site the model runs and no
    BatchNorm. That is the CPU-side proof that no plain version is frozen
    into a program.
  * Each artifact equals the port's eager call bit for bit, and JAX's
    exported artifact on the same weights within the tolerances of
    tests/test_torch_serving.py (mask exact, boxes3d atol 1e-3, probs
    atol 1e-4). For int8 the program is traced while JAX's int8
    activations are replayed (each then a constant of the program), as
    tests/test_torch_quantized.py replays them: free-running, one-level
    moves of the activations compound. They are the activations of
    JAX's jitted serving function, which answers as its exported
    artifact does bit for bit; its eager forward's move a level here and
    there, enough to flip a detection of the artifact.
  * An artifact loads and serves in a fresh process that imports neither
    ``mv3d_tpu_torch.models`` nor ``mv3d_tpu_torch.train``; an artifact
    refuses a device whose platform it does not name.

Artifacts are module-scoped (a trace takes ~10 s here, a load ~5 s, a JAX
export and its first call ~10 s). Wall time about 2 min on the CPU.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from mv3d_tpu.models.mv3d_net import MV3DNet as JaxMV3DNet
from mv3d_tpu.ops import quantized as jq
from mv3d_tpu.serving import build_serving_fn as jax_build_serving_fn
from mv3d_tpu.serving import export_serving as jax_export_serving
from mv3d_tpu.serving import load_serving as jax_load_serving
from mv3d_tpu_torch.models import backbone
from mv3d_tpu_torch.ops import quantize as tquant
from mv3d_tpu_torch.ops import quantized as tq
from mv3d_tpu_torch.serving import (build_serving_fn, export_serving,
                                    load_serving)
from mv3d_tpu_torch.serving.export import _aliases_written, _lean
from mv3d_tpu_torch.train.trainer import MV3D

from test_torch_config import to_port_config
from test_torch_models import randomize_bn
from test_torch_quantized import _drop_without_rgb

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESH = 0.05
TINY = dataclasses.replace(_tiny_config(), model=dataclasses.replace(
    _tiny_config().model, compute_dtype="float32"))
# name -> (pipeline fields, model fields, quantized signature)
CONFIGS = {
    "hwc": (dict(use_pallas_fused=True, voxel_order="sort"), {}, False),
    "s2d2p": (dict(use_pallas_fused=True, voxel_order="sort",
                   view_layout="s2d2p"), {}, False),
    "pallas-sort": (dict(use_pallas_fused=True, voxel_order="pallas-sort"),
                    {}, False),
    "quantized": (dict(use_pallas_fused=True, voxel_order="pallas-sort"),
                  {}, True),
    "int8": (dict(use_pallas_fused=True, voxel_order="sort"),
             dict(quant="int8"), False),
}
FLOAT = ("hwc", "pallas-sort", "quantized", "s2d2p")
# the plain versions' signature ops (aten names)
PLAIN_OPS = ("scatter_reduce", "scatter_reduce_", "index_add", "index_add_",
             "argsort", "searchsorted")
# every served model runs in eval, so every program holds the BatchNorm +
# ReLU epilogue as ``mv3d::bn_relu``
BN_RELU = "mv3d.bn_relu.default"
OPERATORS = {
    "hwc": {"mv3d.voxelize_sweep.default", BN_RELU},
    "s2d2p": {"mv3d.voxelize_padded.default", BN_RELU},
    "pallas-sort": {"mv3d.voxelize_sweep.default",
                    "mv3d.stable_sort.default", BN_RELU},
    "quantized": {"mv3d.voxelize_sweep.default", "mv3d.stable_sort.default",
                  BN_RELU},
    "int8": {"mv3d.voxelize_sweep.default", BN_RELU},
}


def _cfg(name):
    pipe, model, _ = CONFIGS[name]
    return dataclasses.replace(
        TINY, pipeline=dataclasses.replace(TINY.pipeline, **pipe),
        model=dataclasses.replace(TINY.model, **model))


def _inputs(b=2, seed=1):
    """Clouds over the tiny grid with a short last frame, and rgb."""
    rng = np.random.RandomState(seed)
    n = TINY.pipeline.max_points
    pts = np.stack([rng.uniform(0, 16, (b, n)), rng.uniform(-6, 6, (b, n)),
                    rng.uniform(-4, 0.8, (b, n)), rng.uniform(0, 1, (b, n))],
                   axis=-1).astype(np.float32)
    num = np.full((b,), n, np.int32)
    num[-1] = n - 300
    pts[-1, n - 300:] = -1e9
    return pts, num, rng.rand(b, *TINY.rgb_shape).astype(np.float32)


def _signature_inputs(name):
    pts, num, rgb = _inputs()
    if CONFIGS[name][2]:
        q, r = tquant.quantize_points(pts, to_port_config(_cfg(name)))
        return q, r, num, rgb
    return pts, num, rgb


@pytest.fixture(scope="module")
def jax_variables():
    """layout -> JAX variables of the tiny model in that view layout."""
    cache = {}

    def get(layout):
        if layout not in cache:
            cfg = dataclasses.replace(TINY, pipeline=dataclasses.replace(
                TINY.pipeline, view_layout=layout))
            cache[layout] = randomize_bn(jax.jit(JaxMV3DNet(
                cfg).init_variables)(jax.random.PRNGKey(0)), seed=5)
        return cache[layout]
    return get


def _jax_int8_records(variables, cfg):
    """JAX's serving function at ``cfg``, jitted as its export is, on
    ``_inputs()``: its answers and its int8 activations in the order its
    layers quantize them (returned from the same jitted program), less
    those of the head's ``fc_wo_rgb_1/2``, which the port does not
    compute."""
    fn, _ = jax_build_serving_fn(cfg, score_threshold=THRESH)
    acts = []
    real = jq.quantize_activation

    def record(x):
        q, s = real(x)
        acts.append((q, s))
        return q, s

    def with_activations(v, *inputs):
        acts.clear()
        return fn(v, *inputs), list(acts)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, "quantize_activation", record)
        out, records = jax.jit(with_activations)(variables, *_inputs())
    return ([np.asarray(x) for x in out],
            _drop_without_rgb([(np.asarray(q), np.asarray(s))
                               for q, s in records]))


class _Built:
    """A configuration's port model, its artifact loaded on the CPU, and
    the JAX artifact's answers to ``_signature_inputs``."""

    def __init__(self, name, variables, root):
        cfg = _cfg(name)
        variables = variables(cfg.pipeline.view_layout)
        self.name, self.quantized = name, CONFIGS[name][2]
        self.model = MV3D(to_port_config(cfg), device="cpu",
                          variables=variables)
        self.art = export_serving(self.model,
                                  os.path.join(root, name), batch_size=2,
                                  score_threshold=THRESH,
                                  quantized=self.quantized)
        self.served = load_serving(self.art, device="cpu")
        jart = jax_export_serving(variables, cfg, os.path.join(root, "j"
                                                               + name),
                                  batch_size=2, score_threshold=THRESH,
                                  quantized=self.quantized)
        self.jax_out = jax_load_serving(jart)(*_signature_inputs(name))
        self.records = None
        if name == "int8":
            out, self.records = _jax_int8_records(variables, cfg)
            for got, want in zip(out, self.jax_out):    # the same program
                np.testing.assert_array_equal(got, np.asarray(want))


@pytest.fixture(scope="module")
def built(jax_variables, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frozen"))
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _Built(name, jax_variables, root)
        return cache[name]
    return get


def _targets(graph):
    return [str(n.target) for n in graph.nodes if n.op == "call_function"]


def check_graph(built, name):
    b = built(name)
    targets = _targets(b.served.program.graph)
    assert {t for t in targets if t.startswith("mv3d.")} == OPERATORS[name]
    assert not [t for t in targets if t.startswith("aten.")
                and t.split(".")[1] in PLAIN_OPS]
    if name == "int8":
        assert "aten._int_mm.default" in targets


def check_bn_relu_sites(built, name, monkeypatch):
    """One ``mv3d::bn_relu`` node per BatchNorm site the served model runs
    (the eval-mode BatchNorm modules its eager serving call passes through
    ``models.backbone.bn_relu``, each once) and no BatchNorm node: a
    program traced past the operator fails the count."""
    b = built(name)
    sites = []
    real = backbone.bn_relu

    def record(bn, x, dtype):
        sites.append(bn)
        return real(bn, x, dtype)

    monkeypatch.setattr(backbone, "bn_relu", record)
    fn, _ = build_serving_fn(b.model.cfg, THRESH, b.quantized)
    fn(b.model, *_signature_inputs(name))
    assert sites and not any(bn.training for bn in sites)
    assert len({id(bn) for bn in sites}) == len(sites)
    targets = _targets(b.served.program.graph)
    assert targets.count(BN_RELU) == len(sites)
    assert not [t for t in targets if "batch_norm" in t]


def check_lean(built, name):
    """No dtype checks, no casts to the dtype a tensor has, and copies of
    constants only where an op writes to them (``serving.export._lean``)."""
    aten = torch.ops.aten
    for n in built(name).served.program.graph.nodes:
        assert n.target is not aten._assert_tensor_metadata.default
        if n.target is aten.to.dtype:
            assert n.args[0].meta["val"].dtype != n.args[1], n.name
        if n.target is aten.lift_fresh_copy.default:
            assert _aliases_written(n), n.name


def check_equals_eager(built, name):
    """The artifact's answers equal the port's eager serving function on
    the same model, bit for bit."""
    b = built(name)
    inputs = _signature_inputs(name)
    got = b.served(*inputs)
    fn, specs = build_serving_fn(b.model.cfg, THRESH, b.quantized)
    want = fn(b.model, *inputs)
    assert want[2].any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert [s for s, _ in specs(2)] == [a.shape for a in inputs]


def check_matches_jax(built, name, monkeypatch, tmp_path):
    """Within tolerance of JAX's artifact; int8 traced under JAX's
    replayed activations."""
    b = built(name)
    served = b.served
    if name == "int8":
        records = list(b.records)

        def replay(x, group=None):
            q, s = records.pop(0)
            return torch.from_numpy(np.array(
                q.transpose(0, 3, 1, 2) if q.ndim == 4 else q)), \
                torch.tensor(s)

        monkeypatch.setattr(tq, "quantize_activation", replay)
        art = export_serving(b.model, str(tmp_path / "r"),
                             batch_size=2, score_threshold=THRESH)
        assert not records, f"{len(records)} records left"
        served = load_serving(art, device="cpu")
    boxes, probs, mask = served(*_signature_inputs(name))
    want = [np.asarray(x) for x in b.jax_out]
    assert want[2].sum() >= 2
    np.testing.assert_array_equal(mask, want[2])
    np.testing.assert_allclose(boxes[mask], want[0][mask], rtol=0, atol=1e-3)
    np.testing.assert_allclose(probs[mask], want[1][mask], rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", FLOAT)
def test_graph_holds_the_operators(built, name):
    check_graph(built, name)


@pytest.mark.parametrize("name", FLOAT)
def test_graph_holds_one_bn_relu_per_batchnorm_site(built, name,
                                                    monkeypatch):
    check_bn_relu_sites(built, name, monkeypatch)


@pytest.mark.parametrize("name", FLOAT)
def test_graph_is_lean(built, name):
    check_lean(built, name)


class _Constants(torch.nn.Module):
    def forward(self, x):
        read = torch.tensor(2.0)            # read only: its copy goes
        written = torch.tensor([1.0, 2.0])
        written.add_(x.sum())               # written: its copy stays
        return x.to(torch.float32) * read + written.sum(), \
            x.to(torch.float64)


def test_lean_keeps_what_the_program_computes():
    """``_lean`` drops the dtype checks, the cast of a tensor to its own
    dtype and the copy of a constant that nothing writes to, and keeps
    the copy of a written constant and a real cast: the program answers
    as the module does, call after call."""
    x = torch.arange(4, dtype=torch.float32)
    program = torch.export.export(_Constants(), (x,), strict=False)
    before = _targets(program.graph)
    assert "aten._assert_tensor_metadata.default" in before
    _lean(program.graph_module)
    after = _targets(program.graph)
    assert "aten._assert_tensor_metadata.default" not in after
    assert after.count("aten.lift_fresh_copy.default") == 1
    assert before.count("aten.lift_fresh_copy.default") == 2
    assert after.count("aten.to.dtype") == 1        # to float64 stays
    module = program.module()
    for _ in range(2):
        for got, want in zip(module(x), _Constants()(x)):
            assert got.dtype == want.dtype
            torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("name", FLOAT)
def test_frozen_equals_eager(built, name):
    check_equals_eager(built, name)


@pytest.mark.parametrize("name", FLOAT)
def test_frozen_matches_jax_artifact(built, name, monkeypatch, tmp_path):
    check_matches_jax(built, name, monkeypatch, tmp_path)


_FRESH = r"""
import sys
import numpy as np
from mv3d_tpu_torch.serving import load_serving
served = load_serving(sys.argv[1], device="cpu")
n, (h, w, c) = served.meta["max_points"], served.meta["rgb_shape"]
rng = np.random.RandomState(0)
for _ in range(3):
    pts = np.stack([rng.uniform(0, 16, n), rng.uniform(-6, 6, n),
                    rng.uniform(-4, 0.8, n), rng.rand(n)], -1)
    boxes, probs = served.predict(pts.astype(np.float32),
                                  rng.rand(h, w, c).astype(np.float32))
    assert boxes.shape[1:] == (8, 3) and np.isfinite(boxes).all()
bad = sorted(m for m in sys.modules if m.startswith(
    ("mv3d_tpu_torch.models", "mv3d_tpu_torch.train", "jax", "mv3d_tpu.")))
assert not bad, bad
print("ok")
"""


def test_artifact_loads_without_the_model_code(built):
    out = subprocess.run([sys.executable, "-c", _FRESH,
                          built("pallas-sort").art],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_platforms_refuse_other_devices(built, tmp_path, monkeypatch):
    """``platforms=("cpu",)`` (the CPU export's default) refuses the card
    at load, and an artifact for the card alone (its meta rewritten so)
    refuses the CPU; unknown platforms do not export."""
    b = built("hwc")
    assert b.served.meta["platforms"] == ["cpu"]
    cuda_only = shutil.copytree(b.art, str(tmp_path / "c"))
    meta = os.path.join(cuda_only, "meta.json")
    with open(meta) as f:
        m = json.load(f)
    with open(meta, "w") as f:
        json.dump({**m, "platforms": ["cuda"]}, f)
    with pytest.raises(ValueError, match="platforms"):
        load_serving(cuda_only, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="platforms"):
        load_serving(b.art, device="cuda")
    with pytest.raises(ValueError, match="unknown platforms"):
        export_serving(b.model, str(tmp_path / "t"),
                       platforms=("tpu",))
