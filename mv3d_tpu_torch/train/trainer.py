"""User-facing API: ``MV3D`` (inference, weights), ``Predictor`` (an
``MV3D`` that loads its checkpoints) and ``Trainer`` (staged training).

Port of ``mv3d_tpu/train/trainer.py``'s ``MV3D``, ``Predictor`` and
``Trainer``:

  * ``MV3D.predict`` (views in; the ``s2d2p`` layout's view is the
    (heights, aux) pair) and ``predict_from_points`` (raw padded lidar
    points in, optionally with the host aux plane; voxelization and
    detection on the model's device). Both take one frame or a batch and
    return the batch's fixed-shape :class:`Detections` (boxes3d
    (B, R, 8, 3), probs (B, R), mask (B, R)) as tensors on the model's
    device, where the JAX methods return frame 0's masked numpy arrays.
  * per-subnet npz checkpoints in the JAX package's layout
    (``save_weights`` / ``load_weights`` / ``clean_weights``).
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
    :class:`Timer`'s time and re-renders the dashboard.

Entry points run on the card unless given ``device="cpu"``; without CUDA
they raise. Weights come from a seeded ``torch.Generator`` init, from a
JAX variables tree (:mod:`mv3d_tpu_torch.convert`) or from checkpoints.

Not ported (ROADMAP queue A): debug image dumps, the orbax backend,
``debug_mode`` / ``debug_dump``.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import Config, cfg as _default_cfg
from ..convert import load_variables, subnet_state_dict, subnet_variables
from ..models.mv3d_net import MV3DNet, total_loss
from ..models.nets import SUBNET_NAMES
from ..ops.boxes3d import boxes3d_score_iou
from ..ops.detect import Detections
from ..ops.quantize import dequantize_points
from ..ops.voxelize import lidar_to_front_batch, lidar_to_top_batch
from ..utils.dashboard import render_dashboard
from ..utils.logger import Logger
from ..utils.metrics import MetricsWriter
from ..utils.timer import Timer
from .augment import augment_batch
from .checkpoint import SubnetCheckpointer, load_progress, save_progress
from .targets import draw_noise


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
                 log_dir: str = "log"):
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
        ckpt_dir = os.path.join(checkpoint_dir, log_tag)
        self.checkpointers = {name: SubnetCheckpointer(name, ckpt_dir)
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
                 variables: Optional[Mapping[str, Any]] = None):
        super().__init__(cfg, device=device, seed=seed, variables=variables,
                         log_tag=log_tag, checkpoint_dir=checkpoint_dir,
                         log_dir=log_dir)
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
        self.opt_steps = 0
        self.generator = torch.Generator().manual_seed(seed + 1)

    def _to_device(self, v) -> torch.Tensor:
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        return t.to(self.device)

    def _clip_grads(self) -> None:
        """optax.clip_by_global_norm over the trained subnets' gradients."""
        max_norm = self.cfg.train.grad_clip_norm
        grads = [p.grad for p in self.params if p.grad is not None]
        if max_norm <= 0 or not grads:
            return
        norm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum()
                              for g in grads))
        scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
        for g in grads:
            g.mul_(scale)

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
        else:
            loss_dict, aux = self.model.forward_train(batch, noise)
            loss = total_loss(loss_dict, self.train_targets, cfg)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self._clip_grads()
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.opt_steps)
            self.optimizer.step()
            self.opt_steps += 1
        self.model.eval()
        self.last_targets = (aux["rpn_targets"], aux["fusion_targets"])
        return {k: float(v.detach()) for k, v in loss_dict.items()}

    def close(self) -> None:
        super().close()
        self.metrics.close()

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
            if np.any(np.isnan(list(last.values()))):
                # the post-update weights are likely poisoned: save them
                # where latest_step() never looks, keep progress as is
                paths = [self.checkpointers[n].save_crash(
                    subnet_variables(self.model.subnets[n].state_dict()))
                    for n in self.train_targets]
                self.log(f"NaN crash-save at iter {it}: forensic weights "
                         f"at {paths}\n")
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
