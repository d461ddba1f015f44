"""Batch loader: crop + pad, host aux planes, background prefetch.

Port of ``mv3d_tpu/data/loader.py``: ``Frame``, ``frames_to_batch`` and a
single-worker ``BatchLoader``. The host crops and pads each cloud and, with
``pipeline.host_aux_channels`` (the default), computes the BEV
[intensity, density] plane (:mod:`mv3d_tpu_torch.data.host_aux`) in the
prefetch thread, so the card computes only the height channels.

``load()`` returns the batch dict of numpy arrays, with the JAX package's
keys: points (B, N, 4), num_points (B,), rgb (B, H, W, 3) f32,
gt_boxes3d (B, G, 8, 3), gt_labels (B, G), gt_mask (B, G), tags (list),
and top_aux (B, Xn, Yn, 2) when the host computes it.

Not ported: ``stream_quantized``, the multi-worker ticketed loader, the
rgb resize (frames must carry rgb at ``cfg.rgb_shape``) and the KITTI file
readers (ROADMAP A6).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from ..config import Config, cfg as _default_cfg
from . import host_aux


@dataclass
class Frame:
    tag: str
    points: np.ndarray            # (N, 4) lidar
    rgb: Optional[np.ndarray]     # (H, W, 3) uint8 or None
    gt_boxes3d: np.ndarray        # (G, 8, 3)
    gt_labels: np.ndarray         # (G,)


def frames_to_batch(frames: Sequence[Frame], cfg: Config = _default_cfg
                    ) -> Dict[str, np.ndarray]:
    """Pad a list of frames into fixed-shape batch arrays."""
    if cfg.pipeline.stream_quantized:
        raise NotImplementedError("pipeline.stream_quantized is not ported "
                                  "(ROADMAP A6)")
    b = len(frames)
    n = cfg.pipeline.max_points
    g = cfg.pipeline.max_gt
    h, w, _ = cfg.rgb_shape

    points = np.empty((b, n, 4), np.float32)
    num_points = np.zeros(b, np.int32)
    rgb = np.zeros((b, h, w, 3), np.float32)
    gt_boxes3d = np.zeros((b, g, 8, 3), np.float32)
    gt_labels = np.zeros((b, g), np.int32)
    gt_mask = np.zeros((b, g), bool)
    tags = []
    aux = (np.zeros((b, cfg.top.xn, cfg.top.yn, 2), np.float32)
           if cfg.pipeline.host_aux_channels else None)
    for i, f in enumerate(frames):
        points[i], k = host_aux.crop_pad(f.points, n, cfg)
        num_points[i] = k
        if aux is not None:
            aux[i] = host_aux.lidar_to_top_aux(points[i, :k], cfg)
        if f.rgb is not None:
            if f.rgb.shape != (h, w, 3):
                raise NotImplementedError(
                    f"rgb {f.rgb.shape} is not cfg.rgb_shape {(h, w, 3)}: "
                    f"the loader's resize is not ported (ROADMAP A6)")
            rgb[i] = f.rgb
        m = min(len(f.gt_boxes3d), g)
        gt_boxes3d[i, :m] = f.gt_boxes3d[:m]
        gt_labels[i, :m] = f.gt_labels[:m]
        gt_mask[i, :m] = True
        tags.append(f.tag)

    out = {"points": points, "num_points": num_points, "rgb": rgb,
           "gt_boxes3d": gt_boxes3d, "gt_labels": gt_labels,
           "gt_mask": gt_mask, "tags": tags}
    if aux is not None:
        out["top_aux"] = aux
    return out


class BatchLoader:
    """Shuffling loader over any dataset with ``load_frame(i) -> Frame``
    and ``__len__``, with one prefetch thread that assembles whole batches
    ahead of the consumer. The batch stream of a seed is the JAX loader's
    single-worker stream."""

    def __init__(self, dataset, cfg: Config = _default_cfg,
                 batch_size: int = 1, shuffle: bool = True,
                 prefetch: int = 4, seed: int = 0, loop: bool = True):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.loop = loop
        self._rng = np.random.RandomState(seed)
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._finished = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _indices(self) -> Iterator[int]:
        while True:
            order = np.arange(len(self.dataset))
            if self.shuffle:
                self._rng.shuffle(order)
            yield from order
            if not self.loop:
                return

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            indices = self._indices()
            while not self._stop.is_set():
                idxs = [i for _, i in zip(range(self.batch_size), indices)]
                if len(idxs) < self.batch_size:   # a trailing partial
                    break                         # batch is dropped
                frames = [self.dataset.load_frame(int(i)) for i in idxs]
                if not self._put(frames_to_batch(frames, self.cfg)):
                    return
            self._finished = True
        except BaseException as e:   # surface it in load()
            self._error = e
        self._put(None)

    def load(self, timeout: Optional[float] = 60.0):
        """Next batch dict, or None once a non-looping loader is exhausted.
        Raises RuntimeError if the prefetch thread died or stalled."""
        if self._finished and self._queue.empty():
            return None
        try:
            batch = self._queue.get(timeout=timeout)
        except queue.Empty:
            raise RuntimeError(f"BatchLoader stalled: no batch within "
                               f"{timeout} s") from self._error
        if batch is None:
            if self._error is not None:
                raise RuntimeError("BatchLoader worker died while "
                                   "assembling a batch") from self._error
            self._finished = True
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
