"""User-facing API: ``MV3D`` (inference, weights), ``Predictor`` (an
``MV3D`` that loads its checkpoints), ``Trainer`` (staged training) and
the testers the test command runs.

Port of ``mv3d_tpu/train/trainer.py``'s ``MV3D``, ``Predictor``,
``Trainer``, ``PredictorForTest``, ``TesterRPNTarget``, ``TesterRPN`` and
``Tester3DOP``:

  * ``MV3D.predict`` (views in; the ``s2d2p`` layout's view is the
    (heights, aux) pair) and ``predict_from_points`` (raw padded lidar
    points in, optionally with the host aux plane; voxelization and
    detection on the model's device). Both take one frame or a batch and
    return the batch's fixed-shape :class:`Detections` (boxes3d
    (B, R, 8, 3), probs (B, R), mask (B, R)) as tensors on the model's
    device, where the JAX methods return frame 0's masked numpy arrays.
  * per-subnet checkpoints (``save_weights`` / ``load_weights`` /
    ``clean_weights``): npz in the JAX package's layout, or
    ``checkpoint_backend="dcp"`` (``torch.distributed.checkpoint``, saved
    and restored collectively by every rank of a process group, in place
    of the JAX package's orbax).
  * ``Trainer``: one step = augmentation (off by default) -> voxelization
    (heights on the card with the loader's host aux plane in ``"hwc"``;
    every channel on the card in the folded layouts, which take no host
    plane) -> trunks (rematerialized with ``train.remat``) -> RPN ->
    targets -> proposals -> fusion -> losses -> Adam on the trained
    subnets only. Frozen subnets still run in train mode and update their
    BatchNorm statistics, as in the JAX step; their parameters get no
    gradient, which equals optax's ``set_to_zero``. The learning rate is
    constant or optax's ``warmup_cosine_decay_schedule``, indexed by the
    optimizer's own step count as optax does; ``grad_clip_norm`` clips by
    the global norm of the trained subnets' gradients
    (``optax.clip_by_global_norm``). Random draws come from a CPU
    ``torch.Generator`` seeded with ``seed + 1``. The loop interleaves a
    validation step every ``train.validation_every`` iterations (eval-mode
    losses plus :meth:`Trainer.validation_iou`, the host polygon 3D IoU of
    the detections against the gt), writes a :class:`MetricsWriter` row
    per iteration with its phase, and at the checkpoint cadence logs the
    :class:`Timer`'s time and re-renders the dashboard. With
    ``debug_image_every`` it draws gt and detections of a batch's first
    frame every that many iterations
    (:func:`mv3d_tpu_torch.utils.metrics.dump_debug_images`).
  * debugging: with ``debug_mode`` every module of this instance's model
    raises ``FloatingPointError``, naming itself, when its forward output
    holds a NaN or an infinity (JAX's ``jax_debug_nans`` raises at the op),
    and a trainer's step runs under ``torch.autograd.detect_anomaly``, so
    a backward that makes a NaN raises too; nothing global is switched
    on. :meth:`MV3D.debug_dump` writes per-parameter and per-buffer
    statistics; a NaN loss writes them beside the crash checkpoint.
  * the testers return frame 0's masked numpy arrays, as the JAX classes
    do: ``PredictorForTest`` (detections of the main and the twin fusion
    heads, which the default fusion mode aliases, plus debug images),
    ``TesterRPNTarget`` (RPN target assignment over every anchor, with
    its noise drawn by :func:`draw_noise` from a seeded generator),
    ``TesterRPN`` (proposals and the RPN heatmap) and ``Tester3DOP`` (the
    fusion head on given 3D proposals).

Entry points run on the card unless given ``device="cpu"``; without CUDA
they raise. Weights come from a seeded ``torch.Generator`` init, from a
JAX variables tree (:mod:`mv3d_tpu_torch.convert`) or from checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config, cfg as _default_cfg
from ..convert import load_variables, subnet_state_dict, subnet_variables
from ..models.mv3d_net import MV3DNet, total_loss
from ..models.nets import SUBNET_NAMES, TOP_VIEW_RPN
from ..ops import boxes3d as box3d_ops
from ..ops.boxes3d import boxes3d_score_iou
from ..ops.detect import Detections, rcnn_nms
from ..ops.proposal import rpn_proposals
from ..ops.quantize import dequantize_points
from ..ops.voxelize import lidar_to_front_batch, lidar_to_top_batch
from ..utils.dashboard import render_dashboard
from ..utils import viz
from ..utils.logger import Logger
from ..utils.metrics import MetricsWriter, dump_debug_images
from ..utils.png import write_png
from ..utils.timer import Timer
from .augment import augment_batch
from .checkpoint import SubnetCheckpointer, load_progress, save_progress
from .targets import draw_noise, rpn_target


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; the default is the card, and
    asking for the card without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "device='cpu' for the CPU reference")
    return dev


def _prepare_views(batch: Dict[str, torch.Tensor], cfg: Config,
                   use_front: bool) -> Dict[str, torch.Tensor]:
    """Voxelize a raw-point batch on its device (heights only when the
    batch carries the host's ``top_aux``); a quantized batch
    (``points_q``/``refl_q``) is dequantized first; precomputed views
    pass."""
    if "top" in batch:
        return batch
    batch = dict(batch)
    if "points_q" in batch:
        batch["points"] = dequantize_points(batch.pop("points_q"),
                                            batch.pop("refl_q"), cfg)
    pts, num = batch["points"], batch.get("num_points")
    batch["top"], batch["top_occ"] = lidar_to_top_batch(
        pts, cfg, num, aux=batch.pop("top_aux", None), return_occ=True)
    if use_front:
        batch["front"] = lidar_to_front_batch(pts, cfg, num)
    return batch


def first_frame(dets: Detections) -> Tuple[np.ndarray, np.ndarray]:
    """Frame 0's live detections as host f32 arrays: (boxes3d (K, 8, 3),
    probs (K,)), what the JAX package's single-frame methods return."""
    mask = dets.mask[0].cpu().numpy()
    return (dets.boxes3d[0].float().cpu().numpy()[mask],
            dets.probs[0].float().cpu().numpy()[mask])


def top_plane(top) -> np.ndarray:
    """Frame 0 of a batched top view as a drawable host array; of the
    ``s2d2p`` (heights, aux) pair, the heights plane."""
    if isinstance(top, (tuple, list)):
        top = top[0]
    return top[0].float().cpu().numpy()


def _floats(x):
    """The floating-point tensors in a module's output."""
    if torch.is_tensor(x):
        return [x] if x.is_floating_point() else []
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _floats(v)]
    return []


def _finite_hook(name: str):
    def hook(module, inputs, output):
        for t in _floats(output):
            if not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"debug_mode: non-finite output of {name} "
                    f"({type(module).__name__})")
    return hook


def optimizer_steps(optimizer: torch.optim.Optimizer) -> int:
    """The steps ``optimizer`` has taken (optax's ``count``): Adam's
    ``step`` of its parameters, 0 before the first."""
    return max((int(st["step"]) for st in optimizer.state.values()
                if "step" in st), default=0)


def train_step(model: MV3DNet, optimizer: torch.optim.Optimizer, params,
               train_targets, cfg: Config, batch: Dict[str, torch.Tensor],
               noise: Dict[str, torch.Tensor], schedule,
               reduce_grads=None, debug_mode: bool = False
               ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """One optimization step on a batch whose views are made and on its
    draws: the training forward, the loss mix of ``train_targets``, the
    backward (under ``detect_anomaly`` with ``debug_mode``), then
    ``reduce_grads(params)`` if given (a data-parallel gradient sum),
    clipping by ``train.grad_clip_norm``, and ``optimizer``'s step on
    ``params`` at the learning rate ``schedule(optimizer_steps(...))``.
    Leaves the model in eval mode; returns (loss dict, aux)."""
    anomaly = (torch.autograd.detect_anomaly(check_nan=True)
               if debug_mode else contextlib.nullcontext())
    with anomaly:
        loss_dict, aux = model.forward_train(batch, noise)
        loss = total_loss(loss_dict, train_targets, cfg)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    if reduce_grads is not None:
        reduce_grads(params)
    clip_grads(params, cfg.train.grad_clip_norm)
    lr = schedule(optimizer_steps(optimizer))
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    model.eval()
    return loss_dict, aux


def clip_grads(params, max_norm: float) -> None:
    """``optax.clip_by_global_norm(max_norm)`` over the gradients of
    ``params`` (none for ``max_norm <= 0``)."""
    grads = [p.grad for p in params if p.grad is not None]
    if max_norm <= 0 or not grads:
        return
    norm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)


def lr_schedule(cfg: Config, lr: float):
    """count -> learning rate: constant, or optax's
    ``warmup_cosine_decay_schedule`` as the JAX Trainer builds it."""
    tc = cfg.train
    if tc.lr_schedule == "constant":
        return lambda count: lr
    if tc.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {tc.lr_schedule!r}")
    init = 0.0 if tc.warmup_steps else lr
    warmup = tc.warmup_steps
    decay = max(tc.decay_steps, tc.warmup_steps + 1) - warmup
    alpha = tc.lr_end_factor

    def schedule(count: int) -> float:
        if count < warmup:
            return init + (lr - init) * count / warmup
        t = min(count - warmup, decay) / decay
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)

    return schedule


class MV3D:
    """Model + weights on one device: batched inference and per-subnet
    checkpoints."""

    _f32_master = False   # Trainer holds f32 master weights

    def __init__(self, cfg: Config = _default_cfg, device=None,
                 seed: int = 0,
                 variables: Optional[Mapping[str, Any]] = None,
                 log_tag: str = "default", checkpoint_dir: str = "checkpoint",
                 log_dir: str = "log", debug_mode: bool = False,
                 checkpoint_backend: str = "npz"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tag = log_tag
        self.log_dir = log_dir
        self._logger: Optional[Logger] = None
        self.model = MV3DNet(cfg)
        if self._f32_master:
            self.model.master_weights_f32()
        if variables is None:
            self.model.init_weights(torch.Generator().manual_seed(seed))
        else:
            load_variables(self.model, variables)
        self.model.to(self.device).eval()
        self.debug_mode = debug_mode
        if debug_mode:
            for name, module in self.model.named_modules():
                module.register_forward_hook(_finite_hook(name or "MV3DNet"))
        ckpt_dir = os.path.join(checkpoint_dir, log_tag)
        self.checkpointers = {
            name: SubnetCheckpointer(name, ckpt_dir,
                                     backend=checkpoint_backend)
            for name in SUBNET_NAMES}

    def log(self, message: str) -> None:
        """Write to stdout and append to ``<log_dir>/log.txt`` (opened at
        the first message)."""
        if self._logger is None:
            self._logger = Logger(os.path.join(self.log_dir, "log.txt"))
        self._logger.write(message)

    def close(self) -> None:
        """Close the log file (and a trainer's metrics log)."""
        if self._logger is not None:
            self._logger.close()
            self._logger = None

    # -- weights ------------------------------------------------------------

    def get_variables(self) -> Dict[str, Any]:
        """The weights as the JAX package's ``{subnet: {"params",
        "batch_stats"}}`` tree of f32 numpy arrays."""
        return {name: subnet_variables(module.state_dict())
                for name, module in self.model.subnets.items()}

    def save_weights(self, subnets: Optional[Sequence[str]] = None,
                     step: int = 0) -> None:
        for name in (subnets or SUBNET_NAMES):
            self.checkpointers[name].save(
                subnet_variables(self.model.subnets[name].state_dict()), step)

    def load_weights(self, subnets: Optional[Sequence[str]] = None,
                     step: Optional[int] = None) -> None:
        """Restore the stored subnets; keep the current weights of those
        without a checkpoint."""
        for name in (subnets or SUBNET_NAMES):
            stored = self.checkpointers[name].load(step)
            if stored is None:
                self.log(f"Load weights failed for {name}: no checkpoint, "
                         f"using initialized values\n")
                continue
            self.model.subnets[name].load_state_dict(
                subnet_state_dict(stored))
            self.log(f"Load weights for {name} success!\n")

    def clean_weights(self, subnets: Optional[Sequence[str]] = None) -> None:
        for name in (subnets or SUBNET_NAMES):
            self.checkpointers[name].clean()

    def debug_dump(self, path: Optional[str] = None) -> str:
        """Write every parameter's and buffer's statistics (shape, dtype,
        min/max/mean, NaN and infinity counts), one line each as the JAX
        package writes them, to ``<log_dir>/debug/<tag>_weights.txt`` (or
        ``path``) and return the path. Lines name ``subnet.parameter``;
        BatchNorm's ``num_batches_tracked``, which flax has no
        counterpart of, is left out."""
        if path is None:
            d = os.path.join(self.log_dir, "debug")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{self.tag}_weights.txt")
        with open(path, "w") as f:
            for subnet in sorted(self.model.subnets):
                sd = self.model.subnets[subnet].state_dict()
                for key, t in sd.items():
                    if key.endswith("num_batches_tracked"):
                        continue
                    a = t.detach().to("cpu", torch.float32).numpy()
                    f.write(f"{subnet}.{key} {a.shape} "
                            f"{str(t.dtype).replace('torch.', '')} "
                            f"min={a.min():.5g} max={a.max():.5g} "
                            f"mean={a.mean():.5g} "
                            f"nan={int(np.isnan(a).sum())} "
                            f"inf={int(np.isinf(a).sum())}\n")
        return path

    # -- inference ----------------------------------------------------------

    def _batch(self, x, ndim: int, dtype=torch.float32):
        """Array or tensor -> tensor on the model's device, with a batch
        dimension added to a single frame; a (heights, aux) pair is
        batched element by element."""
        if isinstance(x, (tuple, list)):
            return tuple(self._batch(v, ndim, dtype) for v in x)
        t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        t = t.to(self.device, dtype)
        return t[None] if t.dim() == ndim - 1 else t

    @torch.inference_mode()
    def predict(self, top_view, front_view, rgb_image,
                score_threshold: Optional[float] = None) -> Detections:
        """Detection from precomputed NHWC views (single frame or batch;
        for ``view_layout="s2d2p"`` the top view is the (heights, aux)
        pair)."""
        if score_threshold is None:
            score_threshold = self.cfg.rcnn.score_threshold
        self.model.eval()
        top = self._batch(top_view, 4)
        rgb = self._batch(rgb_image, 4)
        front = (self._batch(front_view, 4)
                 if "front" in self.model.views else None)
        dets, _ = self.model.forward_inference(
            top, rgb, front, score_threshold=score_threshold)
        return dets

    @torch.inference_mode()
    def predict_from_points(self, points, num_points, rgb,
                            score_threshold: Optional[float] = None,
                            top_aux=None) -> Detections:
        """Detection from raw padded lidar points (N, 4) or (B, N, 4), their
        valid counts and the rgb image(s): voxelize, then detect. With
        ``top_aux`` ((Xn, Yn, 2) or (B, Xn, Yn, 2), the host's
        intensity/density plane) only the heights are computed here."""
        if score_threshold is None:
            score_threshold = self.cfg.rcnn.score_threshold
        self.model.eval()
        points = self._batch(points, 3)
        rgb = self._batch(rgb, 4)
        num = self._batch(num_points, 1, torch.int32)
        aux = None if top_aux is None else self._batch(top_aux, 4)
        top, occ = lidar_to_top_batch(points, self.cfg, num, aux=aux,
                                      return_occ=True)
        front = (lidar_to_front_batch(points, self.cfg, num)
                 if "front" in self.model.views else None)
        dets, _ = self.model.forward_inference(
            top, rgb, front, score_threshold=score_threshold, top_occ=occ)
        return dets


class Predictor(MV3D):
    """Inference-ready model: loads every subnet checkpoint of its tag on
    construction (subnets without one keep their initialization)."""

    def __init__(self, cfg: Config = _default_cfg, log_tag: str = "default",
                 checkpoint_dir: str = "checkpoint", **kw):
        super().__init__(cfg, log_tag=log_tag, checkpoint_dir=checkpoint_dir,
                         **kw)
        self.load_weights()


class Trainer(MV3D):
    """Staged trainer over any dataset exposing ``load() -> batch dict``
    (raw ``points`` + ``num_points`` [+ ``top_aux``], or ``points_q`` +
    ``refl_q``, or precomputed ``top``/``front`` views; ``rgb``;
    ``gt_boxes3d`` (B, G, 8, 3), ``gt_labels`` (B, G), ``gt_mask`` (B,
    G)), e.g. a :class:`mv3d_tpu_torch.data.loader.BatchLoader`, with an
    optional ``validation_set`` of the same kind for the loop's
    validation steps. The metrics JSONL is
    ``<log_dir>/metrics_<log_tag>.jsonl``."""

    _f32_master = True

    def __init__(self, train_set, validation_set=None,
                 pre_trained_weights: Sequence[str] = (),
                 train_targets: Sequence[str] = SUBNET_NAMES,
                 cfg: Config = _default_cfg, log_tag: str = "default",
                 continue_train: bool = False, lr: Optional[float] = None,
                 checkpoint_dir: str = "checkpoint", log_dir: str = "log",
                 seed: int = 0, device=None,
                 variables: Optional[Mapping[str, Any]] = None,
                 debug_mode: bool = False, checkpoint_backend: str = "npz"):
        super().__init__(cfg, device=device, seed=seed, variables=variables,
                         log_tag=log_tag, checkpoint_dir=checkpoint_dir,
                         log_dir=log_dir, debug_mode=debug_mode,
                         checkpoint_backend=checkpoint_backend)
        if not train_targets or not set(train_targets) <= set(SUBNET_NAMES):
            raise ValueError(f"train_targets {train_targets!r} must be a "
                             f"non-empty subset of {SUBNET_NAMES}")
        self.train_set = train_set
        self.validation_set = validation_set
        self.train_targets = tuple(train_targets)
        self.metrics = MetricsWriter(log_dir, tag=log_tag)
        self.schedule = lr_schedule(
            cfg, cfg.train.lr if lr is None else lr)

        self.n_global_step = 0
        # gt/detection images every this many iterations (0: never)
        self.debug_image_every = 0
        if not continue_train:
            self.clean_weights(self.train_targets)
        else:
            self.n_global_step = load_progress(log_dir, log_tag)
        if pre_trained_weights:
            self.load_weights(pre_trained_weights)
        if continue_train:
            self.load_weights(self.train_targets)

        for name, module in self.model.subnets.items():
            module.requires_grad_(name in self.train_targets)
        self.params = [p for name in self.train_targets
                       for p in self.model.subnets[name].parameters()]
        self.optimizer = torch.optim.Adam(self.params, lr=self.schedule(0),
                                          betas=(0.9, 0.999), eps=1e-8)
        self.generator = torch.Generator().manual_seed(seed + 1)

    def _to_device(self, v) -> torch.Tensor:
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        return t.to(self.device)

    def _clip_grads(self) -> None:
        """optax.clip_by_global_norm over the trained subnets' gradients."""
        clip_grads(self.params, self.cfg.train.grad_clip_norm)

    def fit_iteration(self, batch: Dict[str, np.ndarray],
                      is_validation: bool = False) -> Dict[str, float]:
        """One optimization (or, with ``is_validation``, evaluation) step
        on a host batch dict; returns the four losses and keeps the step's
        (RpnTargets, FusionTargets) in ``last_targets``."""
        cfg = self.cfg
        batch = {k: self._to_device(v) for k, v in batch.items()
                 if k != "tags"}
        if not is_validation:
            batch = augment_batch(batch, cfg, self.generator)
        batch = _prepare_views(batch, cfg, "front" in self.model.views)
        noise = draw_noise(cfg, batch["gt_mask"].shape[0], self.generator,
                           self.device)
        if is_validation:
            with torch.no_grad():
                loss_dict, aux = self.model.forward_train(batch, noise,
                                                          train=False)
            self.model.eval()
        else:
            loss_dict, aux = train_step(
                self.model, self.optimizer, self.params, self.train_targets,
                cfg, batch, noise, self.schedule, debug_mode=self.debug_mode)
        self.last_targets = (aux["rpn_targets"], aux["fusion_targets"])
        return {k: float(v.detach()) for k, v in loss_dict.items()}

    def close(self) -> None:
        super().close()
        self.metrics.close()

    def _dump_debug_images(self, batch, step: int) -> str:
        """Draw the gt and the detections (score gate 0.5) of the batch's
        first frame on its hwc top view (f32, voxelized on the model's
        device; bit-equal to the JAX package's numpy oracle) and its rgb,
        under ``<log_dir>/debug_images/<tag>/<step>``."""
        points = np.asarray(batch["points"][:1])
        num = np.asarray(batch["num_points"][:1])
        rgb = np.asarray(batch["rgb"][0])
        boxes3d, _ = first_frame(self.predict_from_points(
            points, num, rgb, score_threshold=0.5))
        hwc = dataclasses.replace(self.cfg, pipeline=dataclasses.replace(
            self.cfg.pipeline, view_layout="hwc", top_view_dtype="float32"))
        with torch.inference_mode():
            top = lidar_to_top_batch(self._batch(points, 3), hwc,
                                     self._batch(num, 1, torch.int32))
        gm = np.asarray(batch["gt_mask"][0])
        return dump_debug_images(
            os.path.join(self.log_dir, "debug_images", self.tag), step,
            top_plane(top), rgb=rgb,
            gt_boxes3d=np.asarray(batch["gt_boxes3d"][0])[gm],
            det_boxes3d=boxes3d, cfg=self.cfg)

    def validation_iou(self, batch: Dict[str, np.ndarray],
                       score_threshold: Optional[float] = None) -> float:
        """Detection quality of one validation batch: predict from its
        points (every view channel on the card, no host plane, as the JAX
        package does) and score each frame's live detections against its
        positive gt with :func:`boxes3d_score_iou`. Frames without
        positive gt are skipped; returns the mean (0.0 if none is left).
        The score gate defaults to ``rcnn.score_threshold``."""
        if "points_q" in batch:
            points = dequantize_points(torch.from_numpy(batch["points_q"]),
                                       torch.from_numpy(batch["refl_q"]),
                                       self.cfg)
        else:
            points = batch["points"]
        num = batch.get("num_points")
        if num is None:
            num = np.full(points.shape[0], points.shape[1], np.int32)
        dets = self.predict_from_points(points, num, batch["rgb"],
                                        score_threshold=score_threshold)
        det_mask = dets.mask.cpu().numpy()
        det_boxes = dets.boxes3d.float().cpu().numpy()
        gt3d = np.asarray(batch["gt_boxes3d"])
        gm = np.asarray(batch["gt_mask"]) & (np.asarray(batch["gt_labels"])
                                             > 0)
        ious = [boxes3d_score_iou(gt3d[i][gm[i]],
                                  det_boxes[i][det_mask[i]], self.cfg)
                for i in range(det_boxes.shape[0]) if gm[i].any()]
        return float(np.mean(ious)) if ious else 0.0

    def __call__(self, max_iter: int = 1000) -> Dict[str, float]:
        """The training loop: every ``train.validation_every``-th iteration
        (not the first) is a validation step on ``validation_set`` when
        there is one; batches without positive gt are skipped; each step
        is logged to ``<log_dir>/log.txt`` (validation lines with the IoU)
        and written to the metrics JSONL with its phase; every
        ``train.ckpt_every`` steps the trained subnets are saved, the time
        since the last save logged and the dashboard re-rendered (a
        failed render is logged, never raised), and at the end they are
        saved again. On a NaN loss ``<subnet>-crash.npz`` is saved and
        ``FloatingPointError`` raised."""
        cfg = self.cfg
        validation_step = cfg.train.validation_every
        ckpt_every = cfg.train.ckpt_every
        timer = Timer()
        self.log("iter |  top_cls_loss   reg_loss   |  fuse_cls_loss  "
                 "reg_loss  |\n")
        last: Dict[str, float] = {}
        init_step = self.n_global_step
        for it in range(init_step, init_step + max_iter):
            is_validation = (self.validation_set is not None
                             and it % validation_step == 0 and it > 0)
            data_set = self.validation_set if is_validation \
                else self.train_set
            batch = data_set.load()
            if batch is None:
                continue
            if not np.any(np.asarray(batch["gt_labels"]) *
                          np.asarray(batch["gt_mask"])):
                continue
            last = self.fit_iteration(batch, is_validation=is_validation)
            step_name = "validation" if is_validation else "training"
            line = "%10s: %5d  %0.5f  %0.5f  |  %0.5f  %0.5f" % (
                step_name, it, last["top_cls_loss"], last["top_reg_loss"],
                last["fuse_cls_loss"], last["fuse_reg_loss"])
            if is_validation:
                last["iou"] = self.validation_iou(batch)
                line += "  |  iou %0.5f" % last["iou"]
            self.log(line + "\n")
            self.metrics.write(it, last, phase=step_name)
            if (self.debug_image_every and it > 0
                    and it % self.debug_image_every == 0
                    and "points" in batch):
                self._dump_debug_images(batch, it)
            if np.any(np.isnan(list(last.values()))):
                # the post-update weights are likely poisoned: save them
                # where latest_step() never looks, keep progress as is,
                # and record which arrays went non-finite
                try:
                    paths = [self.checkpointers[n].save_crash(
                        subnet_variables(self.model.subnets[n].state_dict()))
                        for n in self.train_targets]
                    dump = self.debug_dump()
                    self.log(f"NaN crash-save at iter {it}: forensic weights "
                             f"at {paths}, stats at {dump}\n")
                except Exception as e:  # the original error must surface
                    self.log(f"NaN crash-save failed: {e}\n")
                raise FloatingPointError(
                    f"NaN loss at iter {it}: {last} (forensic crash "
                    f"checkpoint saved; resume uses the last good cadence "
                    f"checkpoint)")
            self.n_global_step = it + 1
            if it > 0 and it % ckpt_every == 0:
                self.save_weights(self.train_targets, it)
                save_progress(self.log_dir, self.tag, self.n_global_step)
                self.log("It takes %0.2f secs to train %d iterations.\n" % (
                    timer.time_diff_per_n_loops(), ckpt_every))
                try:
                    render_dashboard(self.log_dir)
                except Exception as e:  # observability never kills training
                    self.log(f"dashboard render failed: {e}\n")
        self.save_weights(self.train_targets, self.n_global_step)
        save_progress(self.log_dir, self.tag, self.n_global_step)
        return last


class PredictorForTest(MV3D):
    """Diagnostic predictor: the main detections plus those of the twin
    fusion heads (with and without RGB), each NMS'd on its own, and
    annotated debug images.

    After a call ``boxes3d_with_rgb`` / ``probs_with_rgb`` /
    ``boxes3d_without_rgb`` / ``probs_without_rgb`` hold the twin heads'
    results (in the default fusion mode they are the main head's), and
    :meth:`dump_log` draws the last frame's proposals, gt and detections.
    """

    def __init__(self, cfg: Config = _default_cfg, log_tag: str = "default",
                 checkpoint_dir: str = "checkpoint", load: bool = True,
                 **kw):
        super().__init__(cfg, log_tag=log_tag, checkpoint_dir=checkpoint_dir,
                         **kw)
        if load:
            self.load_weights()
        self._last = None

    @torch.inference_mode()
    def _predict3(self, top, rgb, front, score_threshold: float):
        model, cfg = self.model, self.cfg
        outs = model.extract_features(top, rgb, front)
        rpn = outs["rpn"]
        props = rpn_proposals(rpn["scores"], rpn["deltas"], model.anchors,
                              model.anchor_mask(top), cfg)
        boxes = props.rois[..., 1:5]
        rois3d = box3d_ops.top_box_to_box3d(boxes, cfg)
        fuse = model.fuse_rois(outs, rois3d, boxes)
        dets = {head: rcnn_nms(fuse["probs" + head], fuse["deltas" + head],
                               rois3d, props.mask,
                               score_threshold=score_threshold, cfg=cfg)
                for head in ("", "_with_rgb", "_without_rgb")}
        return dets, props

    def __call__(self, top_view, front_view, rgb_image,
                 nms_threshold: Optional[float] = None, gt_boxes3d=None):
        """One frame's views (or a batch, of which frame 0 is reported);
        ``nms_threshold`` is the score gate, as in the JAX class. Returns
        (boxes3d, [], probs)."""
        if nms_threshold is None:
            nms_threshold = self.cfg.rcnn.score_threshold
        self.model.eval()
        top = self._batch(top_view, 4)
        rgb = self._batch(rgb_image, 4)
        front = (self._batch(front_view, 4)
                 if "front" in self.model.views else None)
        dets, props = self._predict3(top, rgb, front, nms_threshold)
        boxes3d, probs = first_frame(dets[""])
        for head in ("_with_rgb", "_without_rgb"):
            b, p = first_frame(dets[head])
            setattr(self, "boxes3d" + head, b)
            setattr(self, "probs" + head, p)
        pm = props.mask[0].cpu().numpy()
        self._last = {
            "top": top_plane(top), "rgb": rgb[0].cpu().numpy(),
            "proposals": props.rois[0].cpu().numpy()[pm][:, 1:5],
            "boxes3d": boxes3d,
            "gt_boxes3d": (np.asarray(gt_boxes3d)
                           if gt_boxes3d is not None else None),
        }
        return boxes3d, [], probs

    def dump_log(self, log_subdir: str, n_frame: int) -> str:
        """Write annotated BEV/camera PNGs of the last prediction under
        ``<log_dir>/<log_subdir>/<n_frame>``."""
        assert self._last is not None, "call the predictor first"
        return dump_debug_images(
            os.path.join(self.log_dir, log_subdir), n_frame,
            self._last["top"], rgb=self._last["rgb"],
            gt_boxes3d=self._last["gt_boxes3d"],
            det_boxes3d=self._last["boxes3d"],
            proposals=self._last["proposals"], cfg=self.cfg)


class TesterRPNTarget(MV3D):
    """RPN target-assignment prober: sampled and positive anchor counts,
    and the sampled anchors drawn over the BEV image. Targets are
    assigned over every anchor (no empty-anchor filter)."""

    def __init__(self, cfg: Config = _default_cfg, log_tag: str = "default",
                 checkpoint_dir: str = "checkpoint", **kw):
        super().__init__(cfg, log_tag=log_tag, checkpoint_dir=checkpoint_dir,
                         **kw)
        self._last = None

    @torch.inference_mode()
    def __call__(self, top_view, gt_boxes3d, gt_labels, seed: int = 0,
                 noise: Optional[Dict[str, Any]] = None) -> Tuple[int, int]:
        """Returns (sampled, positive) anchor counts. The sampling draws
        come from :func:`draw_noise` with a generator seeded by ``seed``,
        unless ``noise`` gives ``rpn_pos`` and ``rpn_neg`` ((A,) or
        (1, A))."""
        cfg, dev = self.cfg, self.device
        g = len(gt_boxes3d)
        gt3d = self._batch(np.asarray(gt_boxes3d, np.float32), 4)
        labels = self._batch(np.asarray(gt_labels), 2, torch.int64)
        if noise is None:
            noise = draw_noise(cfg, 1, torch.Generator().manual_seed(seed),
                               dev)
        u_pos, u_neg = (self._batch(noise[k], 2)
                        for k in ("rpn_pos", "rpn_neg"))
        anchors = self.model.anchors
        tg = rpn_target(anchors,
                        torch.ones(1, anchors.shape[0], dtype=torch.bool,
                                   device=dev),
                        box3d_ops.box3d_to_top_box(gt3d, cfg), labels,
                        torch.ones(1, g, dtype=torch.bool, device=dev),
                        u_pos, u_neg, cfg)
        top = (top_view[0] if isinstance(top_view, (tuple, list))
               else top_view)        # of the s2d2p pair, the heights
        top = top if torch.is_tensor(top) else np.asarray(top)
        top = top[0] if top.ndim == 4 else top
        self._last = {"top": (top.float().cpu().numpy()
                              if torch.is_tensor(top) else top),
                      "gt_boxes3d": np.asarray(gt_boxes3d),
                      "cls_mask": tg.cls_mask[0].cpu().numpy(),
                      "labels": tg.labels[0].cpu().numpy(),
                      "pos_mask": tg.pos_mask[0].cpu().numpy()}
        return (int(self._last["cls_mask"].sum()),
                int(self._last["pos_mask"].sum()))

    def anchors_details(self) -> str:
        return "anchors: positive= {} total= {}\n".format(
            int(self._last["pos_mask"].sum()),
            int(self._last["cls_mask"].sum()))

    def dump_log(self, log_subdir: str, step: int = 0) -> str:
        """Sampled anchors over the BEV image (negatives gray, positives
        blue, gt white) as ``<log_dir>/<log_subdir>/rpn_target_<step>.png``."""
        assert self._last is not None, "call the tester first"
        anchors = self.model.anchors.cpu().numpy()
        img = viz.draw_top_image(self._last["top"])
        neg = self._last["cls_mask"] & ~self._last["pos_mask"]
        img = viz.draw_boxes2d(img, anchors[neg], color=(128, 128, 128))
        img = viz.draw_boxes2d(img, anchors[self._last["pos_mask"]],
                               color=(0, 64, 255))
        if len(self._last["gt_boxes3d"]):
            img = viz.draw_box3d_on_top(img, self._last["gt_boxes3d"],
                                        color=(255, 255, 255), cfg=self.cfg)
        d = os.path.join(self.log_dir, log_subdir)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"rpn_target_{step:06d}.png")
        write_png(path, img)
        return path


class TesterRPN(MV3D):
    """RPN-only prober: a frame's proposals, their scores and the RPN's
    score heatmap (only the ``top_view_rpn`` checkpoint is loaded)."""

    def __init__(self, cfg: Config = _default_cfg, log_tag: str = "default",
                 checkpoint_dir: str = "checkpoint", load: bool = True,
                 **kw):
        super().__init__(cfg, log_tag=log_tag, checkpoint_dir=checkpoint_dir,
                         **kw)
        if load:
            self.load_weights([TOP_VIEW_RPN])

    def proposals(self, top):
        """The RPN on a batched top view (any layout, the ``s2d2p`` pair
        included): (Proposals, score map (B, H', W', 2 * bases))."""
        with torch.inference_mode():
            out = self.model.top_rpn(top)
            props = rpn_proposals(out["scores"], out["deltas"],
                                  self.model.anchors,
                                  self.model.anchor_mask(top), self.cfg)
        return props, out["score_map"]

    def __call__(self, top_view):
        """Returns frame 0's (rois (K, 5), scores (K,), heatmap)."""
        self.model.eval()
        props, heatmap = self.proposals(self._batch(top_view, 4))
        mask = props.mask[0].cpu().numpy()
        return (props.rois[0].cpu().numpy()[mask],
                props.scores[0].cpu().numpy()[mask],
                heatmap[0].cpu().numpy())


class Tester3DOP(MV3D):
    """The fusion head on externally supplied (K, 8, 3) 3D proposals (e.g.
    3DOP's), bypassing the RPN."""

    def __init__(self, cfg: Config = _default_cfg, log_tag: str = "default",
                 checkpoint_dir: str = "checkpoint", load: bool = True,
                 **kw):
        super().__init__(cfg, log_tag=log_tag, checkpoint_dir=checkpoint_dir,
                         **kw)
        if load:
            self.load_weights()

    @torch.inference_mode()
    def __call__(self, top_view, front_view, rgb_image, rois3d,
                 score_threshold: Optional[float] = None):
        """Returns frame 0's (probs (K,), boxes3d (K, 8, 3))."""
        if score_threshold is None:
            score_threshold = self.cfg.rcnn.score_threshold
        model, cfg = self.model, self.cfg
        model.eval()
        top = self._batch(top_view, 4)
        rgb = self._batch(rgb_image, 4)
        front = (self._batch(front_view, 4) if "front" in model.views
                 else None)
        rois3d = self._batch(np.asarray(rois3d, np.float32), 4)
        outs = model.extract_features(top, rgb, front)
        fuse = model.fuse_rois(outs, rois3d,
                               box3d_ops.box3d_to_top_box(rois3d, cfg))
        dets = rcnn_nms(fuse["probs"], fuse["deltas"], rois3d,
                        torch.ones(rois3d.shape[:2], dtype=torch.bool,
                                   device=self.device),
                        score_threshold=score_threshold, cfg=cfg)
        boxes3d, probs = first_frame(dets)
        return probs, boxes3d
