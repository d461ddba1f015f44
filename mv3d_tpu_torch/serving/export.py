"""Serving artifacts of the lidar -> boxes program: export, load, call.

Port of ``mv3d_tpu/serving/export.py``. As the JAX artifact freezes the
whole pipeline as a ``jax.export`` program, this one freezes it with
``torch.export``: :func:`export_serving` traces :func:`build_serving_fn`
at the artifact's signature on the model's device, with the port's
kernels recorded as the ``mv3d::`` operators (:mod:`..ops.library`), and
a serving host needs the artifact directory, ``mv3d_tpu_torch.serving``
and those operators, but not the model code (``models``, ``train``) or
the configuration:

  ``serving_fn.pt2``  the ``torch.export`` program (``torch.export.save``)
                      with its weights, kept on the CPU whatever device
                      traced it;
  ``weights.npz``     ``MV3D.get_variables()`` flattened with ``/``-joined
                      keys: the JAX ``_flatten``'s keys and its HWIO/flax
                      arrays, so weights cross between the two packages;
  ``meta.json``       the JAX fields (batch size, quantized, score
                      threshold, platforms, max points, rgb shape, input
                      and output names, the quantization grid), with
                      ``torch_version`` in place of ``jax_version``,
                      ``traced_on`` and ``program``;
  ``config.json``     the configuration the program was traced at
                      (loading reads none of it).

``platforms`` are the devices the artifact may run on (``cuda``, ``cpu``;
the export device by default). Since the dispatcher picks each operator's
kernel or plain version from the tensors' device, a program traced on
the CPU launches the kernels on the card, the counterpart of JAX's
cross-lowering; ``load_serving`` refuses a device whose platform the
artifact does not name, as JAX's runtime refuses a backend with no
lowering. The signature is frozen as in JAX: the batch size is fixed, a
short batch is padded with empty frames (``num_points=0``, rows at -1e9),
numpy goes in and numpy comes out, and a quantized artifact's host
quantizes from ``meta["quant_bounds"]`` alone. An int8 artifact
(``model.quant="int8"``) freezes the int8 forward with the int8 weights
and their scales as constants of the program (quantized once, at
export); its activations are quantized at each call, as in eager.

The program runs its aten ops as the eager model does (nothing is
compiled) and its kernels through the operators.

Spans (``utils.profiling``; open only while a profiler runs, so
``profiling.trace`` output shows them as ``user_annotation`` events).
:meth:`ServingModel.predict_batch` opens ``mv3d.serve.request`` around
the whole request (the host's moments between two stages are in it and
in no stage), and inside it one span for each host stage, in this
order: ``mv3d.serve.cut`` (each cloud cut to the bucket),
``mv3d.serve.pad`` (the padded point batch and counts),
``mv3d.serve.rgb`` (the float32 image batch), ``mv3d.serve.quantize``
(quantized artifacts), ``mv3d.serve.h2d`` (the inputs to the device),
``mv3d.serve.program`` (the program's launches), ``mv3d.serve.d2h`` (the
answers to the host, which waits for the device) and
``mv3d.serve.unpack`` (each frame's live detections); a raw
:meth:`ServingModel.__call__` opens the middle three. Inside
``mv3d.serve.program`` the network's stages are ranges
``mv3d.program.<stage>`` (``voxelize``, ``top_trunk``, ``rgb_trunk``,
``front_trunk`` with the front view, ``proposals``, ``roi_fusion``,
``detect``; AVOD's are ``voxelize``, ``bev_pyramid``, ``img_pyramid``,
``rpn``, ``proposal_nms``, ``second_stage`` and ``detect``): the export
keeps each traced node's stage as node metadata
(``torch.fx.traceback.annotate``) and :func:`load_serving` wraps each run
of one stage in its range; an artifact without the metadata loads
without them. Every kernel of the program is launched inside exactly one.
An artifact whose program returns counters (``meta["counter_names"]``;
AVOD's non-empty anchors and proposal-NMS visits a frame) records each
request's sum over its frames with ``utils.profiling.count`` after the
copy back, while a profiler runs.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from ..ops import library  # noqa: F401  (registers the mv3d:: operators)
from ..config import AvodConfig, Config
from ..data.host_aux import within_budget
from ..device import resolve_device
from ..utils.profiling import add_stage_ranges, count, span, stage

_PROGRAM_FILE = "serving_fn.pt2"
_WEIGHTS_FILE = "weights.npz"
_META_FILE = "meta.json"
_CONFIG_FILE = "config.json"
PLATFORMS = ("cuda", "cpu")
# the numpy dtype of each input the signature may name
_INPUT_DTYPES = {"points": np.float32, "points_q": np.uint16,
                 "refl_q": np.uint8, "num_points": np.int32,
                 "rgb": np.float32}


# -- nested-dict (de)flattening for the weights npz ---------------------------

def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if "/" in str(k):
            raise ValueError(f"weight tree key {k!r} contains '/'")
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif v is not None:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


# -- the configuration as JSON ------------------------------------------------

def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def config_from_dict(d: Dict[str, Any], like=None):
    """Inverse of ``dataclasses.asdict`` on a :class:`Config`: each field
    takes the type of ``like``'s (a default ``Config``, or
    :class:`AvodConfig` for a tree with AVOD's settings), so JSON's lists
    become the tuples they were."""
    if like is None:
        like = AvodConfig() if "avod" in d else Config()
    names = {f.name for f in dataclasses.fields(like)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"unknown config fields {sorted(unknown)}")
    kw = {}
    for name, v in d.items():
        old = getattr(like, name)
        kw[name] = (config_from_dict(v, old) if dataclasses.is_dataclass(old)
                    else _tuples(v) if isinstance(old, tuple) else v)
    return dataclasses.replace(like, **kw)


# -- the serving function -----------------------------------------------------

def build_serving_fn(cfg: Config, score_threshold: float = 0.05,
                     quantized: bool = False):
    """Return ``(fn, input_specs(batch_size))`` for the serving program.

    ``fn(model, *inputs) -> (boxes3d, probs, mask)`` runs the lidar ->
    boxes pipeline on an :class:`~mv3d_tpu_torch.train.trainer.MV3D`
    built at ``cfg``, on its device; a network with counters
    (``counter_names``, AVOD) also returns them, (B, n) int32. Inputs
    (arrays or tensors):

      * default: ``points (B,N,4) f32``, ``num_points (B,) i32``,
        ``rgb (B,H,W,3) f32``;
      * ``quantized=True``: ``points_q (B,N,3) u16``, ``refl_q (B,N) u8``,
        ``num_points (B,) i32``, ``rgb (B,H,W,3) f32``, dequantized on the
        device (:mod:`mv3d_tpu_torch.ops.quantize`).

    ``input_specs(b)`` gives each input's (shape, numpy dtype)."""
    n = cfg.pipeline.max_points
    h, w, c = cfg.rgb_shape

    def run(model, points, num_points, rgb):
        dets, counters = model.predict_from_points(
            points, num_points, rgb, score_threshold, counters=True)
        out = (dets.boxes3d, dets.probs, dets.mask)
        return out if counters is None else out + (counters,)

    if quantized:
        from ..ops.quantize import dequantize_points

        def fn(model, points_q, refl_q, num_points, rgb):
            dev = model.device
            with stage("voxelize"):
                pts = dequantize_points(torch.as_tensor(points_q).to(dev),
                                        torch.as_tensor(refl_q).to(dev), cfg)
            return run(model, pts, num_points, rgb)

        def input_specs(b: int):
            return (((b, n, 3), np.uint16), ((b, n), np.uint8),
                    ((b,), np.int32), ((b, h, w, c), np.float32))
        return fn, input_specs

    def input_specs(b: int):
        return (((b, n, 4), np.float32), ((b,), np.int32),
                ((b, h, w, c), np.float32))
    return run, input_specs


# -- export / load ------------------------------------------------------------

class _Program(torch.nn.Module):
    """The serving function over one model, as the module that
    ``torch.export`` traces: the network's parameters and buffers are its
    state, the signature's inputs its arguments."""

    def __init__(self, model, fn):
        super().__init__()
        self.net = model.model
        self._model, self._fn = model, fn

    def forward(self, *inputs):
        return self._fn(self._model, *inputs)


_ATEN = torch.ops.aten


def _aliases_written(node) -> bool:
    """Whether a mutable op may write to ``node``'s value or to a view of
    it (``detach_`` changes no value); also True where the value reaches
    the graph's outputs or an op whose schema cannot be read (answers
    that cannot be proven no)."""
    todo, seen = [node], {node}
    while todo:
        for user in todo.pop().users:
            if user.op != "call_function" or not isinstance(
                    user.target, torch._ops.OpOverload):
                return True
            schema = user.target._schema
            if schema.is_mutable and user.target is not _ATEN.detach_.default:
                return True
            if any(r.alias_info is not None for r in schema.returns) \
                    and user not in seen:
                seen.add(user)
                todo.append(user)
    return False


def _lean(gm: torch.fx.GraphModule) -> None:
    """Remove, in place, the nodes that the trace adds around the eager
    model's ops and that cost host time at every call (B=1 serving is
    bound by the host): the dtype checks (``_assert_tensor_metadata``),
    casts to the dtype a tensor already has (``to.dtype``, which returns
    the tensor itself), and the copies of constant tensors that no op
    writes to (``lift_fresh_copy``). The graph's inputs and outputs keep
    their names, so the program's signature still holds."""
    graph = gm.graph
    for n in list(graph.nodes):
        if n.op != "call_function":
            continue
        if n.target is _ATEN._assert_tensor_metadata.default:
            graph.erase_node(n)
            continue
        if any(u.op == "output" for u in n.users):
            continue
        src = n.args[0] if n.args else None
        if n.target is _ATEN.to.dtype:
            val = src.meta.get("val") if isinstance(src, torch.fx.Node) \
                else None
            extra = dict(zip(("non_blocking", "copy", "memory_format"),
                             n.args[2:]), **n.kwargs)
            if (isinstance(val, torch.Tensor) and val.dtype == n.args[1]
                    and not extra.get("copy")
                    and extra.get("memory_format") in (
                        None, torch.preserve_format)):
                n.replace_all_uses_with(src)
                graph.erase_node(n)
        elif (n.target is _ATEN.lift_fresh_copy.default
              and not _aliases_written(n)):
            n.replace_all_uses_with(src)
            graph.erase_node(n)
    graph.lint()
    gm.recompile()


def _platforms(platforms: Optional[Sequence[str]], dev: torch.device):
    out = list(platforms) if platforms else [dev.type]
    bad = [p for p in out if p not in PLATFORMS]
    if bad:
        raise ValueError(f"unknown platforms {bad}: expected some of "
                         f"{list(PLATFORMS)}")
    return out


def export_serving(model, out_dir: str, batch_size: int = 1,
                   score_threshold: float = 0.05, quantized: bool = False,
                   platforms: Optional[Sequence[str]] = None) -> str:
    """Trace the serving program of ``model`` (an ``MV3D``) at its
    configuration with ``torch.export.export(strict=False)`` on its
    device, at the signature of ``batch_size`` frames, and write the
    artifact to ``out_dir``; returns ``out_dir``.

    ``platforms``: the devices the artifact may run on (default: the
    model's device); the program is the same for all of them. An int8
    model's kept int8 weights (``models.backbone.keep_quantized``) enter
    the program as constants. Each node keeps the stage it was traced in
    (``utils.profiling.stage``). The model's train/eval mode is
    restored."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    from ..models.backbone import keep_quantized
    cfg = model.cfg
    platforms = _platforms(platforms, model.device)
    fn, input_specs = build_serving_fn(cfg, score_threshold, quantized)
    example = tuple(torch.zeros(shape, dtype=torch.from_numpy(
        np.zeros(0, dt)).dtype, device=model.device)
        for shape, dt in input_specs(batch_size))
    training = model.model.training
    model.model.eval()
    try:
        keep_quantized(model.model)
        with torch.fx.traceback.preserve_node_meta():
            program = torch.export.export(_Program(model, fn), example,
                                          strict=False)
    finally:
        model.model.train(training)
    program.example_inputs = None     # zeros of the signature: not kept
    _lean(program.graph_module)
    if model.device.type != "cpu":
        program = move_to_device_pass(program, "cpu")
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, _PROGRAM_FILE))
    np.savez(os.path.join(out_dir, _WEIGHTS_FILE),
             **_flatten(model.get_variables()))
    meta = {
        "batch_size": batch_size,
        "quantized": quantized,
        "score_threshold": score_threshold,
        "platforms": platforms,
        "max_points": cfg.pipeline.max_points,
        "rgb_shape": list(cfg.rgb_shape),
        "torch_version": torch.__version__,
        "traced_on": model.device.type,
        "program": _PROGRAM_FILE,
        "input_names": (["points_q", "refl_q", "num_points", "rgb"]
                        if quantized else ["points", "num_points", "rgb"]),
        "output_names": ["boxes3d", "probs", "mask"],
    }
    counter_names = list(getattr(model.model, "counter_names", ()))
    if counter_names:
        meta["output_names"].append("counters")
        meta["counter_names"] = counter_names
    if quantized:
        # the grid the host quantizes with: serving hosts need no config
        from ..ops.quantize import _bounds
        lo, hi = _bounds(cfg)
        meta["quant_bounds"] = {"lo": lo.tolist(), "hi": hi.tolist()}
    with open(os.path.join(out_dir, _META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    with open(os.path.join(out_dir, _CONFIG_FILE), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    return out_dir


class ServingModel:
    """A loaded serving artifact: numpy in, numpy out, fixed signature.
    ``program`` is the frozen program's module on ``device``."""

    def __init__(self, program: torch.nn.Module, meta: Dict[str, Any],
                 device: torch.device):
        self.program = program
        self.meta = meta
        self.device = device
        self._dtypes = [_INPUT_DTYPES[n] for n in meta["input_names"]]

    def __call__(self, *inputs) -> Tuple[np.ndarray, ...]:
        """Raw batched call matching ``meta['input_names']``; the arrays
        of ``meta['output_names']``."""
        with torch.inference_mode():
            with span("mv3d.serve.h2d"):
                args = [torch.from_numpy(np.ascontiguousarray(x, dt)).to(
                    self.device) for x, dt in zip(inputs, self._dtypes)]
            with span("mv3d.serve.program"):
                out = self.program(*args)
        with span("mv3d.serve.d2h"):
            return tuple(o.cpu().numpy() for o in out)

    def predict(self, points: np.ndarray, rgb: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """One (M, 4) cloud and its rgb -> (boxes3d (K, 8, 3), probs (K,))
        of the live detections, at any artifact batch size (the frame is
        padded to it with empty frames)."""
        return self.predict_batch([(points, rgb)])[0]

    def predict_batch(self, frames: Sequence[Tuple[np.ndarray, np.ndarray]]
                      ) -> list:
        """Run up to ``meta['batch_size']`` (points (M, 4), rgb (H, W, 3))
        frames in one execution: each cloud is cut to the point bucket as
        the loader cuts a cropped one (an evenly spaced subset where it
        holds more, ``data.host_aux.within_budget``), the batch is padded
        with empty frames (``num_points=0``). Returns one (boxes3d
        (K, 8, 3), probs (K,)) pair per frame."""
        bsz = self.meta["batch_size"]
        if not 1 <= len(frames) <= bsz:
            raise ValueError(
                f"predict_batch got {len(frames)} frames; artifact batch "
                f"size is {bsz}")
        with span("mv3d.serve.request"):
            n = self.meta["max_points"]
            h, w, c = self.meta["rgb_shape"]
            with span("mv3d.serve.cut"):
                clouds = [within_budget(np.asarray(p, np.float32), n)
                          for p, _ in frames]
            with span("mv3d.serve.pad"):
                pts = np.full((bsz, n, 4), -1e9, np.float32)
                num = np.zeros(bsz, np.int32)
                for i, p in enumerate(clouds):
                    pts[i, : p.shape[0]] = p
                    num[i] = p.shape[0]
            with span("mv3d.serve.rgb"):
                rgbs = np.zeros((bsz, h, w, c), np.float32)
                for i, (_, r) in enumerate(frames):
                    rgbs[i] = np.asarray(r, np.float32)
            if self.meta["quantized"]:
                from ..ops.quantize import quantize_points
                b = self.meta["quant_bounds"]
                with span("mv3d.serve.quantize"):
                    q, rq = quantize_points(pts, bounds=(b["lo"], b["hi"]))
                boxes3d, probs, mask, *counters = self(q, rq, num, rgbs)
            else:
                boxes3d, probs, mask, *counters = self(pts, num, rgbs)
            for c in counters:
                for name, col in zip(self.meta["counter_names"],
                                     c[:len(frames)].T):
                    count(name, int(col.sum()))
            with span("mv3d.serve.unpack"):
                return [(boxes3d[i][mask[i]], probs[i][mask[i]])
                        for i in range(len(frames))]


def load_serving(artifact_dir: str, device=None) -> ServingModel:
    """Load the program of an artifact written by :func:`export_serving`
    onto ``device`` (the card by default; raises without CUDA). Refuses a
    device whose platform is not in ``meta["platforms"]``. Each run of one
    stage of the program is wrapped in its range
    (``utils.profiling.add_stage_ranges``)."""
    dev = resolve_device(device)
    with open(os.path.join(artifact_dir, _META_FILE)) as f:
        meta = json.load(f)
    if dev.type not in meta["platforms"]:
        raise ValueError(f"the artifact {artifact_dir} was exported for "
                         f"platforms {meta['platforms']}, not {dev.type}")
    program = torch.export.load(os.path.join(artifact_dir, meta["program"]))
    if dev.type != "cpu":
        program = move_to_device_pass(program, dev)
    module = program.module()
    add_stage_ranges(module)
    return ServingModel(module, meta, dev)
