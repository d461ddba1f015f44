"""Serving artifacts of the lidar -> boxes program: export, load, call.

Port of ``mv3d_tpu/serving/export.py``. The JAX artifact freezes the whole
pipeline as a ``jax.export`` StableHLO program. The port cannot freeze its
path with ``torch.export``: its kernels are ctypes launches and its NMS is
data-dependent. So the artifact directory holds the weights, the signature
and the configuration, and the serving host rebuilds the program from
``mv3d_tpu_torch`` at that configuration:

  ``weights.npz``  ``MV3D.get_variables()`` flattened with ``/``-joined
                   keys: the JAX ``_flatten``'s keys and its HWIO/flax
                   arrays, so weights cross between the two packages;
  ``meta.json``    the JAX fields (batch size, quantized, score threshold,
                   max points, rgb shape, input and output names, the
                   quantization grid), with ``torch_version`` in place of
                   ``platforms``/``jax_version``;
  ``config.json``  the full configuration, restored field by field.

There is no cross-lowering (``platforms=("tpu", "cpu")``):
``load_serving(dir, device=None)`` chooses the device, the card by default.
The signature is frozen as in JAX: the batch size is fixed, a short batch
is padded with empty frames (``num_points=0``, rows at -1e9), numpy goes in
and numpy comes out, and a quantized artifact's host quantizes from
``meta["quant_bounds"]`` alone. An int8 artifact (``model.quant="int8"``)
is a float artifact whose ``config.json`` says ``quant="int8"``: the
weights are the float ones, quantized by the serving forward.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from ..config import Config

_WEIGHTS_FILE = "weights.npz"
_META_FILE = "meta.json"
_CONFIG_FILE = "config.json"


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
    takes the type of ``like``'s (a default ``Config``), so JSON's lists
    become the tuples they were."""
    like = Config() if like is None else like
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
    built at ``cfg``, on its device. Inputs (arrays or tensors):

      * default: ``points (B,N,4) f32``, ``num_points (B,) i32``,
        ``rgb (B,H,W,3) f32``;
      * ``quantized=True``: ``points_q (B,N,3) u16``, ``refl_q (B,N) u8``,
        ``num_points (B,) i32``, ``rgb (B,H,W,3) f32``, dequantized on the
        device (:mod:`mv3d_tpu_torch.ops.quantize`).

    ``input_specs(b)`` gives each input's (shape, numpy dtype)."""
    n = cfg.pipeline.max_points
    h, w, c = cfg.rgb_shape

    def run(model, points, num_points, rgb):
        dets = model.predict_from_points(points, num_points, rgb,
                                         score_threshold)
        return dets.boxes3d, dets.probs, dets.mask

    if quantized:
        from ..ops.quantize import dequantize_points

        def fn(model, points_q, refl_q, num_points, rgb):
            dev = model.device
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


# -- export / load --------------------------------------------------------------

def export_serving(variables, cfg: Config, out_dir: str, batch_size: int = 1,
                   score_threshold: float = 0.05,
                   quantized: bool = False) -> str:
    """Write the artifact of ``variables`` (the JAX-layout tree of
    ``MV3D.get_variables()`` or of the JAX package) at ``cfg`` to
    ``out_dir`` and return it."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, _WEIGHTS_FILE), **_flatten(variables))
    meta = {
        "batch_size": batch_size,
        "quantized": quantized,
        "score_threshold": score_threshold,
        "max_points": cfg.pipeline.max_points,
        "rgb_shape": list(cfg.rgb_shape),
        "torch_version": torch.__version__,
        "input_names": (["points_q", "refl_q", "num_points", "rgb"]
                        if quantized else ["points", "num_points", "rgb"]),
        "output_names": ["boxes3d", "probs", "mask"],
    }
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
    """A loaded serving artifact: numpy in, numpy out, fixed signature."""

    def __init__(self, model, meta: Dict[str, Any]):
        self.model = model
        self.cfg = model.cfg
        self.meta = meta
        self._fn, _ = build_serving_fn(model.cfg, meta["score_threshold"],
                                       meta["quantized"])

    def __call__(self, *inputs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Raw batched call matching ``meta['input_names']``."""
        out = self._fn(self.model, *inputs)
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
        frames in one execution: each cloud is cut to the point bucket, the
        batch is padded with empty frames (``num_points=0``). Returns one
        (boxes3d (K, 8, 3), probs (K,)) pair per frame."""
        bsz = self.meta["batch_size"]
        if not 1 <= len(frames) <= bsz:
            raise ValueError(
                f"predict_batch got {len(frames)} frames; artifact batch "
                f"size is {bsz}")
        n = self.meta["max_points"]
        h, w, c = self.meta["rgb_shape"]
        pts = np.full((bsz, n, 4), -1e9, np.float32)
        num = np.zeros(bsz, np.int32)
        rgbs = np.zeros((bsz, h, w, c), np.float32)
        for i, (p, r) in enumerate(frames):
            p = np.asarray(p, np.float32)[:n]
            pts[i, : p.shape[0]] = p
            num[i] = p.shape[0]
            rgbs[i] = np.asarray(r, np.float32)
        if self.meta["quantized"]:
            from ..ops.quantize import quantize_points
            b = self.meta["quant_bounds"]
            q, rq = quantize_points(pts, bounds=(b["lo"], b["hi"]))
            boxes3d, probs, mask = self(q, rq, num, rgbs)
        else:
            boxes3d, probs, mask = self(pts, num, rgbs)
        return [(boxes3d[i][mask[i]], probs[i][mask[i]])
                for i in range(len(frames))]


def load_serving(artifact_dir: str, device=None) -> ServingModel:
    """Load an artifact written by :func:`export_serving` onto ``device``
    (the card by default; raises without CUDA)."""
    from ..train.trainer import MV3D
    with np.load(os.path.join(artifact_dir, _WEIGHTS_FILE)) as z:
        variables = _unflatten({k: z[k] for k in z.files})
    with open(os.path.join(artifact_dir, _META_FILE)) as f:
        meta = json.load(f)
    with open(os.path.join(artifact_dir, _CONFIG_FILE)) as f:
        cfg = config_from_dict(json.load(f))
    return ServingModel(MV3D(cfg, device=device, variables=variables), meta)
