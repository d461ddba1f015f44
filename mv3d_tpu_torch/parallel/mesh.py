"""Device meshes and data-parallel train and inference steps.

Port of ``mv3d_tpu/parallel/mesh.py`` on ``torch.distributed``: one
process per device, a ``DeviceMesh`` with a ``data`` axis (and the
reserved ``model`` axis; ``make_hybrid_mesh`` adds ``dcn``), the batch
split over the data-like axes, parameters replicated.

JAX's sharded step is one jitted program over the global batch, so every
batch reduction in it is global. The port's steps reproduce that on each
rank's shard:

  * BatchNorm: train-mode statistics over the global batch (every roi of
    every rank in the fusion head), by the layers' ``group``
    (:class:`mv3d_tpu_torch.models.backbone.BatchNorm`);
  * losses: each rank computes its share of the global losses (the
    model's ``group``: the fusion losses' masked sums over the global
    counts, the per-frame RPN losses over the global frame count); the
    shares sum to the global losses, so the sum of the ranks' gradients
    is the global loss's gradient;
  * random draws: every rank draws the global batch's noise from the same
    generator state and keeps its own frames' rows, as JAX splits one key
    into per-frame keys of the global batch;
  * int8 activation scales: the amax is all-reduced with MAX, as it is a
    global reduction under ``jit``.

:func:`global_batch` sets the group on the model and on its layers for
the length of a step. The train step is ``Trainer``'s
(:func:`mv3d_tpu_torch.train.trainer.train_step`: the learning-rate
schedule at the optimizer's step count, clipping, Adam) with the
gradients summed by an explicit all-reduce of one flat buffer between
``backward`` and the clipping (the trained subnets' parameters that
received a gradient, in parameter order), so every rank steps alike.
DDP's module wrapper is not used: it would wrap the staged subnets of
``train_targets`` only, while the frozen subnets still run in train
mode, and the ``fc_wo_rgb_*`` layers run without gradient for their
statistics alone.

The process group's backend follows the device: NCCL on the card, gloo
on the CPU (:func:`init_process_group`). One NCCL rank needs one card.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_BATCH_AXES = ("dcn", "data")


def init_process_group(device, rank: int, world_size: int,
                       init_method: str) -> torch.device:
    """Join the default process group (``init_method`` e.g.
    ``tcp://localhost:<port>`` or ``file://<path>``): NCCL for a CUDA
    ``device``, gloo for the CPU. On CUDA the rank's card is
    ``cuda:<rank % device_count>``. Returns the device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for gloo "
                               "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


def _device_type(devices) -> str:
    if devices is None:
        return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return torch.device(devices).type


def _check_world(n: int, what: str) -> None:
    if n != dist.get_world_size():
        raise ValueError(f"{what} has {n} devices; the process group has "
                         f"{dist.get_world_size()} ranks (one per device)")


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1,
              devices=None) -> DeviceMesh:
    """A (data, model) mesh over the process group's ranks (``n_devices``,
    if given, must be their number). ``devices`` is the device type
    ("cuda" or "cpu"; by default that of the group's backend)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    if n % model_axis:
        raise ValueError(f"{n} devices do not split into model axes of "
                         f"{model_axis}")
    _check_world(n, "the mesh")
    return init_device_mesh(_device_type(devices), (n // model_axis,
                                                    model_axis),
                            mesh_dim_names=("data", "model"))


def make_hybrid_mesh(n_slices: int, devices_per_slice: Optional[int] = None,
                     devices=None) -> DeviceMesh:
    """A ("dcn", "data", "model") mesh for multi-slice deployments: the
    batch splits over both ``dcn`` and ``data``, parameters stay
    replicated. The gradient sum is one all-reduce over both axes."""
    world = dist.get_world_size()
    if devices_per_slice is None:
        if world % n_slices:
            raise ValueError(f"{world} ranks do not split into {n_slices} "
                             f"slices")
        devices_per_slice = world // n_slices
    _check_world(n_slices * devices_per_slice, "the hybrid mesh")
    return init_device_mesh(_device_type(devices),
                            (n_slices, devices_per_slice, 1),
                            mesh_dim_names=("dcn", "data", "model"))


def _shape(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_divisor(mesh: DeviceMesh) -> int:
    """Number of ways the leading batch axis is split on this mesh."""
    shape = _shape(mesh)
    return int(np.prod([shape[a] for a in _BATCH_AXES if a in shape]))


def _batch_index(mesh: DeviceMesh) -> int:
    """This rank's position along the batch split (dcn-major)."""
    shape = _shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for a in _BATCH_AXES:
        if a in shape:
            index = index * shape[a] + coord[a]
    return index


def batch_group(mesh: DeviceMesh):
    """The process group of the ranks that split one batch: every rank
    when the model axis is 1, else this rank's ``data`` group."""
    if _shape(mesh)["model"] == 1:
        return dist.group.WORLD
    return mesh.get_group("data")


def replicate(tree, mesh: DeviceMesh):
    """Broadcast a module's parameters and buffers (or a dict of tensors)
    from rank 0 to every rank, in place; returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tensors = [t.data for t in tree.parameters()] + list(tree.buffers())
    else:
        tensors = list(tree.values())
    for t in tensors:
        dist.broadcast(t, src=0)
    return tree


def check_batch_divisible(batch: Dict[str, Any], mesh: DeviceMesh) -> None:
    """Raise a clear ValueError when a batch cannot split over the mesh."""
    n = batch_divisor(mesh)
    for k, v in batch.items():
        if hasattr(v, "shape") and np.ndim(v) and v.shape[0] % n:
            raise ValueError(
                f"batch axis of '{k}' has size {v.shape[0]}, not divisible "
                f"by the mesh's {n}-way data sharding "
                f"(mesh {_shape(mesh)}); pad or rebatch so that "
                f"batch % {n} == 0")


def shard_batch(batch: Dict[str, Any], mesh: DeviceMesh) -> Dict[str, Any]:
    """This rank's rows of every batch array of the global ``batch`` (its
    leading axis split over the mesh's data-like axes); other values pass
    as they are."""
    check_batch_divisible(batch, mesh)
    n, i = batch_divisor(mesh), _batch_index(mesh)
    return {k: (v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                if hasattr(v, "shape") and np.ndim(v) else v)
            for k, v in batch.items()}


@contextlib.contextmanager
def global_batch(model: torch.nn.Module, group):
    """Make ``model``'s batch reductions global over ``group`` while the
    block runs: BatchNorm statistics in train mode, int8 activation
    scales, and an ``MV3DNet``'s training losses."""
    from ..models.backbone import BatchNorm, Conv2d, Linear
    from ..models.mv3d_net import MV3DNet
    layers = [m for m in model.modules()
              if isinstance(m, (BatchNorm, Conv2d, Linear, MV3DNet))]
    for m in layers:
        m.group = group
    try:
        yield
    finally:
        for m in layers:
            m.group = None


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def _sum_grads(params, group) -> None:
    """Sum the gradients of ``params`` over ``group``'s ranks in place,
    as one flat all-reduce."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, r in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(r.view_as(g))


def make_sharded_train_step(model, optimizer: torch.optim.Optimizer,
                            train_targets, mesh: DeviceMesh, cfg=None,
                            schedule=None):
    """Data-parallel train step of an ``MV3DNet`` on this rank's device.

    Returns ``step(batch, noise) -> losses``: ``batch`` is this rank's
    shard (:func:`shard_batch`) of a training batch (raw points, or
    precomputed views, with the gt), ``noise`` a CPU ``torch.Generator``
    from which the global batch's draws are made
    (:func:`mv3d_tpu_torch.train.targets.draw_noise`), or those draws as
    a dict of (B_global, ...) arrays. The step is ``Trainer``'s
    (:func:`mv3d_tpu_torch.train.trainer.train_step`) with the gradients
    summed over the mesh: it updates ``model`` (the trained subnets'
    parameters through ``optimizer``, every running BatchNorm statistic)
    and ``optimizer`` in place on every rank alike, at the learning rate
    ``schedule(count)`` (``Trainer.schedule``; by default
    ``lr_schedule(cfg, cfg.train.lr)``) of the optimizer's step count.
    It returns the global batch's four losses as floats and keeps this
    rank's (RpnTargets, FusionTargets) in ``step.last_targets``."""
    from ..train.targets import draw_noise
    from ..train.trainer import _prepare_views, lr_schedule, train_step

    cfg = cfg or model.cfg
    schedule = schedule or lr_schedule(cfg, cfg.train.lr)
    group = batch_group(mesh)
    n, index = batch_divisor(mesh), _batch_index(mesh)
    params = [p for name in train_targets
              for p in model.subnets[name].parameters()]
    device = next(model.parameters()).device

    def step(batch: Dict[str, Any],
             noise: Union[torch.Generator, Mapping[str, Any]]
             ) -> Dict[str, float]:
        batch = {k: _tensor(v).to(device) for k, v in batch.items()
                 if k != "tags"}
        b = batch["gt_mask"].shape[0]
        if isinstance(noise, torch.Generator):
            noise = draw_noise(cfg, b * n, noise)
        noise = {k: _tensor(v)[index * b:(index + 1) * b].to(device)
                 for k, v in noise.items()}
        batch = _prepare_views(batch, cfg, "front" in model.views)
        with global_batch(model, group):
            loss_dict, aux = train_step(
                model, optimizer, params, train_targets, cfg, batch, noise,
                schedule, reduce_grads=lambda ps: _sum_grads(ps, group))
        step.last_targets = (aux["rpn_targets"], aux["fusion_targets"])
        losses = torch.stack([v.detach() for v in loss_dict.values()])
        dist.all_reduce(losses, group=group)
        return dict(zip(loss_dict, losses.tolist()))

    return step


def make_sharded_infer_step(model, mesh: DeviceMesh,
                            score_threshold: float = 0.05):
    """Batch-sharded inference of an ``MV3DNet`` on this rank's device.

    Returns ``infer(points, rgb, num_points=None) -> Detections``: this
    rank's shard of raw padded points (b, N, 4) and rgb, voxelized and
    detected here (with ``quant="int8"`` over activation scales global to
    the mesh); the detections of the global batch come back on every
    rank, in batch order, as JAX's global output array does."""
    from ..ops.detect import Detections
    from ..ops.voxelize import lidar_to_front_batch, lidar_to_top_batch

    cfg = model.cfg
    group = batch_group(mesh)
    n = batch_divisor(mesh)
    device = next(model.parameters()).device

    @torch.inference_mode()
    def infer(points, rgb, num_points=None) -> Detections:
        pts = _tensor(points).to(device, torch.float32)
        rgb = _tensor(rgb).to(device, torch.float32)
        num = (None if num_points is None
               else _tensor(num_points).to(device, torch.int32))
        model.eval()
        top, occ = lidar_to_top_batch(pts, cfg, num, return_occ=True)
        front = (lidar_to_front_batch(pts, cfg, num)
                 if "front" in model.views else None)
        with global_batch(model, group):
            dets, _ = model.forward_inference(
                top, rgb, front, score_threshold=score_threshold,
                top_occ=occ)
        out = []
        for x in dets:
            # the masks travel as bytes: not every backend takes bool
            y = x.to(torch.uint8) if x.dtype == torch.bool else x
            parts = [torch.empty_like(y) for _ in range(n)]
            dist.all_gather(parts, y.contiguous(), group=group)
            out.append(torch.cat(parts).to(x.dtype))
        return Detections(*out)

    return infer
