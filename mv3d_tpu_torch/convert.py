"""Flax variables <-> PyTorch ``state_dict``s for the four MV3D subnets.

The JAX package keeps its weights as ``{subnet: {"params": ...,
"batch_stats": ...}}`` trees of arrays (``jax.tree.map(np.asarray,
variables)``, or what ``SubnetCheckpointer.load`` returns per subnet). The
port's modules carry flax's own names (``trunk/Bottleneck_0/Conv_1`` is
``trunk.Bottleneck_0.Conv_1``), so the mapping is per leaf:

  * conv ``kernel`` HWIO -> ``weight`` OIHW; dense ``kernel`` (in, out) ->
    ``weight`` (out, in); ``bias`` -> ``bias``;
  * a transposed conv's ``kernel`` (a module flax auto-names
    ``ConvTranspose_<i>``) HWIO -> ``weight`` (in, out, kh, kw) flipped in
    both spatial dims: flax's ``ConvTranspose`` correlates the dilated
    input with its kernel as given, ``F.conv_transpose2d`` with the
    kernel flipped (:class:`mv3d_tpu_torch.models.backbone.ConvTranspose2d`);
  * BatchNorm ``scale``/``bias`` -> ``weight``/``bias`` and ``mean``/``var``
    -> ``running_mean``/``running_var`` (plus a zero
    ``num_batches_tracked``, which flax does not keep).

A BatchNorm is recognised by its leaves, not its name: a flax module
holding ``scale``, ``mean`` or ``var``; a torch module holding
``running_mean`` or ``running_var``, or a 1-D ``weight`` (a conv's is
4-D, a dense layer's 2-D), so a dict of parameters or gradients alone
maps too. Flax auto-names most of them ``BatchNorm_<i>``, but the split
stem's is ``stem_bn``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
_BN_INV = {v: k for k, v in _BN_LEAVES.items()}


def _walk(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _flax_bn_modules(variables: Mapping[str, Any]):
    return {path[:-1] for collection in ("params", "batch_stats")
            for path, _ in _walk(variables.get(collection, {}))
            if path[-1] in ("scale", "mean", "var")}


def _torch_bn_modules(state_dict: Mapping[str, torch.Tensor]):
    return {tuple(key.split(".")[:-1]) for key, t in state_dict.items()
            if key.endswith((".running_mean", ".running_var"))
            or (key.endswith(".weight") and t.dim() == 1)}


def _transposed(mod) -> bool:
    return bool(mod) and mod[-1].startswith("ConvTranspose")


def _kernel_to_torch(a: np.ndarray, transposed: bool = False) -> np.ndarray:
    if transposed:
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T


def _kernel_to_flax(a: np.ndarray, transposed: bool = False) -> np.ndarray:
    if transposed:
        return a.transpose(2, 3, 0, 1)[::-1, ::-1]
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T


def subnet_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One subnet's ``{"params", "batch_stats"}`` tree -> ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    bn = _flax_bn_modules(variables)
    for collection in ("params", "batch_stats"):
        for path, arr in _walk(variables.get(collection, {})):
            mod, leaf = path[:-1], path[-1]
            a = np.asarray(arr, dtype=np.float32)
            if mod in bn:
                name = _BN_LEAVES[leaf]
            elif leaf == "kernel":
                name, a = "weight", _kernel_to_torch(a, _transposed(mod))
            elif leaf == "bias":
                name = "bias"
            else:
                raise KeyError(f"unexpected leaf {'/'.join(path)}")
            sd[".".join(mod + (name,))] = torch.tensor(
                np.ascontiguousarray(a))
            if mod in bn and leaf == "mean":
                sd[".".join(mod + ("num_batches_tracked",))] = torch.tensor(0)
    return sd


def subnet_variables(state_dict: Mapping[str, torch.Tensor]
                     ) -> Dict[str, Any]:
    """Inverse of :func:`subnet_state_dict` (``num_batches_tracked`` is
    dropped): ``state_dict`` -> ``{"params", "batch_stats"}`` of f32
    numpy arrays."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    bn = _torch_bn_modules(state_dict)
    for key, t in state_dict.items():
        *mod, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        a = t.detach().to("cpu", torch.float32, copy=True).numpy()
        if tuple(mod) in bn:
            leaf = _BN_INV[name]
            collection = ("batch_stats" if name.startswith("running_")
                          else "params")
        elif name == "weight":
            leaf, collection = "kernel", "params"
            a = np.ascontiguousarray(_kernel_to_flax(a, _transposed(mod)))
        else:
            leaf, collection = name, "params"
        node = out[collection]
        for p in mod:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out


def load_variables(model, variables: Mapping[str, Any]) -> None:
    """Load a JAX ``{subnet: variables}`` tree into an ``MV3DNet``
    (strict: every parameter and buffer must be matched)."""
    for name, module in model.subnets.items():
        module.load_state_dict(subnet_state_dict(variables[name]))
