"""Batch loader: rgb crop + resize, crop + pad, host aux planes, an
ordered multi-worker prefetch.

Port of ``mv3d_tpu/data/loader.py``:

  * :func:`prepare_rgb`: the camera-image crop, then a resize to
    ``cfg.rgb_shape`` by :func:`resize_bilinear`, a numpy port of PIL's
    ``BILINEAR`` resample (the JAX loader calls PIL), equal to it bit for
    bit;
  * :func:`frames_to_batch`: the host crops and pads each cloud and, with
    ``pipeline.host_aux_channels`` (the default), computes the BEV
    [intensity, density] plane (:mod:`mv3d_tpu_torch.data.host_aux`), so
    the card computes only the height channels; with
    ``pipeline.stream_quantized`` the points travel as ``points_q`` /
    ``refl_q`` (:mod:`mv3d_tpu_torch.ops.quantize`), which the trainer
    dequantizes on the card;
  * :class:`BatchLoader`: ``workers`` threads each build whole batches and
    a ticket sequencer emits them in order, so a seed's batch stream is
    the single-worker stream and the JAX loader's; damaged frames are
    skipped and replaced from the shared index stream.

``load()`` returns the batch dict of numpy arrays, with the JAX package's
keys: points (B, N, 4) (or points_q (B, N, 3) uint16 and refl_q (B, N)
uint8), num_points (B,), rgb (B, H, W, 3) f32, gt_boxes3d (B, G, 8, 3),
gt_labels (B, G), gt_mask (B, G), tags (list), and top_aux
(B, Xn, Yn, 2) when the host computes it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config, cfg as _default_cfg
from . import host_aux
from .kitti import Frame

__all__ = ["BatchLoader", "Frame", "frames_to_batch", "prepare_rgb",
           "resize_bilinear"]

# PIL's fixed point for 8-bit resampling: 32 - 8 - 2 bits of fraction
PRECISION_BITS = 22


def _coefficients(in_size: int, out_size: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` for the bilinear (triangle) filter over
    the whole input, then ``normalize_coeffs_8bpc``: per output pixel the
    first input index ``xmin`` (out_size,) and the fixed-point weights
    (out_size, ksize), zero past each pixel's support. The arithmetic is
    PIL's, in float64 and in its order, so the weights are its bits."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    k = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for x in range(ksize):
        w = np.maximum(1.0 - np.abs((x + xmin - center + 0.5) * ss), 0.0)
        w = np.where(x < xmax, w, 0.0)
        k[:, x] = w
        ww = ww + w                           # summed in PIL's order
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None],
                 k)
    scaled = k * (1 << PRECISION_BITS)
    fixed = np.where(k < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled))
    return xmin, fixed.astype(np.int32)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit resample along ``axis`` of a uint8 image:
    integer sums from a half-unit start, shifted and clipped to uint8."""
    xmin, k = _coefficients(img.shape[axis], out_size)
    # int32 as PIL's: 255 times weights summing to about 2**22 fits
    src = img.astype(np.int32)
    w_shape = [1] * img.ndim
    w_shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int32)
    last = img.shape[axis] - 1
    for x in range(k.shape[1]):
        tap = np.take(src, np.minimum(xmin + x, last), axis=axis)
        np.multiply(tap, k[:, x].reshape(w_shape), out=tap)
        np.add(acc, tap, out=acc)
    np.right_shift(acc, PRECISION_BITS, out=acc)
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize_bilinear(rgb: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8, as PIL's
    ``Image.resize((width, height), BILINEAR)``: a horizontal pass into a
    uint8 intermediate, then a vertical pass, each skipped where its size
    does not change."""
    if rgb.dtype != np.uint8:
        raise ValueError(f"resize_bilinear takes uint8, not {rgb.dtype}")
    out = rgb
    if width != rgb.shape[1]:
        out = _resample_axis(out, width, 1)
    if height != rgb.shape[0]:
        out = _resample_axis(out, height, 0)
    return out


def prepare_rgb(rgb: np.ndarray, cfg: Config) -> np.ndarray:
    """Camera-image crop (the didi sky and hood rows), then a resize to
    ``cfg.rgb_shape``."""
    ct, cb = cfg.image_crop_top, cfg.image_crop_bottom
    cl, cr = cfg.image_crop_left, cfg.image_crop_right
    if ct or cb or cl or cr:
        rgb = rgb[ct: rgb.shape[0] - cb if cb else rgb.shape[0],
                  cl: rgb.shape[1] - cr if cr else rgb.shape[1]]
    h, w, _ = cfg.rgb_shape
    return resize_bilinear(rgb, h, w)


def frames_to_batch(frames: Sequence[Frame], cfg: Config = _default_cfg
                    ) -> Dict[str, np.ndarray]:
    """Pad a list of frames into fixed-shape batch arrays."""
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
            rgb[i] = prepare_rgb(f.rgb, cfg)
        m = min(len(f.gt_boxes3d), g)
        gt_boxes3d[i, :m] = f.gt_boxes3d[:m]
        gt_labels[i, :m] = f.gt_labels[:m]
        gt_mask[i, :m] = True
        tags.append(f.tag)

    out = {"points": points, "num_points": num_points, "rgb": rgb,
           "gt_boxes3d": gt_boxes3d, "gt_labels": gt_labels,
           "gt_mask": gt_mask, "tags": tags}
    if cfg.pipeline.stream_quantized:
        # 7 bytes a point instead of 16; dequantized on the card
        from ..ops.quantize import quantize_points
        out["points_q"], out["refl_q"] = quantize_points(points, cfg)
        del out["points"]
    if aux is not None:
        out["top_aux"] = aux
    return out


class BatchLoader:
    """Shuffling, prefetching batch loader over any dataset with
    ``load_frame(i) -> Frame`` and ``__len__``.

    ``workers`` threads each build whole batches (file reads, PNG decode,
    resize, crop + pad, aux plane, assembly) and a ticket sequencer emits
    them in index order, so for a given seed the batch stream is the
    single-worker stream; zlib, the PNG helper and most numpy work release
    the GIL. A frame whose ``load_frame`` raises is skipped and replaced
    by the next index of the shared stream. ``close()`` stops and joins
    the threads.
    """

    def __init__(self, dataset, cfg: Config = _default_cfg,
                 batch_size: int = 1, shuffle: bool = True,
                 prefetch: int = 4, seed: int = 0, loop: bool = True,
                 workers: int = 1):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.loop = loop
        self._rng = np.random.RandomState(seed)
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._finished = False                 # all workers exited cleanly
        self._lock = threading.Lock()          # index stream + tickets
        self._index_iter = self._indices()
        self._next_ticket = 0
        self._emit_cv = threading.Condition()  # ordered emission
        self._emit_ticket = 0
        self._live = max(1, int(workers))
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(self._live)]
        for t in self._threads:
            t.start()

    def _indices(self) -> Iterator[int]:
        while True:
            order = np.arange(len(self.dataset))
            if self.shuffle:
                self._rng.shuffle(order)
            yield from order
            if not self.loop:
                return

    def _take_group(self):
        """Claim the next batch's frame indices + its emission ticket."""
        with self._lock:
            idxs = [i for _, i in zip(range(self.batch_size),
                                      self._index_iter)]
            if len(idxs) < self.batch_size:   # exhausted (non-loop): the
                return None, None             # trailing partial batch drops,
            t = self._next_ticket             # matching the 1-worker path
            self._next_ticket += 1
            return t, idxs

    def _take_replacement(self):
        with self._lock:
            return next(self._index_iter, None)

    def _skip_ticket(self, ticket):
        """Abandon a claimed ticket (stream ran dry mid-batch) so workers
        holding later tickets don't wait on it forever."""
        with self._emit_cv:
            while self._emit_ticket != ticket:
                if self._stop.is_set():
                    return
                self._emit_cv.wait(timeout=0.5)
            self._emit_ticket += 1
            self._emit_cv.notify_all()

    def _put_ordered(self, ticket, batch) -> bool:
        with self._emit_cv:
            while self._emit_ticket != ticket:
                if self._stop.is_set():
                    return False
                self._emit_cv.wait(timeout=0.5)
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue
            self._emit_ticket += 1
            self._emit_cv.notify_all()
            return not self._stop.is_set()

    def _worker(self):
        try:
            while not self._stop.is_set():
                ticket, idxs = self._take_group()
                if ticket is None:
                    return
                frames: List[Frame] = []
                for i in idxs:
                    while i is not None and not self._stop.is_set():
                        try:
                            frames.append(self.dataset.load_frame(int(i)))
                            break
                        except Exception as e:  # damaged frame: skip it
                            # and pull a replacement from the index stream
                            print(f"loader: skipping frame {i}: {e}")
                            i = self._take_replacement()
                if len(frames) < self.batch_size:
                    self._skip_ticket(ticket)   # stream ran dry mid-batch
                    return
                if not self._put_ordered(ticket,
                                         frames_to_batch(frames, self.cfg)):
                    return
        except BaseException as e:  # batch assembly died: surface it in
            self._error = e         # load() instead of a silent None
            with self._emit_cv:     # release peers waiting on our ticket
                self._stop.set()
                self._emit_cv.notify_all()
        finally:
            with self._lock:
                self._live -= 1
                last = self._live == 0
            if last:
                if self._error is None:
                    self._finished = True   # clean exhaustion, not a death
                self._queue.put(None)

    def load(self, timeout: Optional[float] = 60.0):
        """Next batch dict, or None when a non-looping loader is exhausted
        (every call after exhaustion keeps returning None).

        Raises RuntimeError (with the worker's exception chained, if any)
        when the prefetch threads died or produced nothing within
        ``timeout`` — a stall must be loud, not an anonymous queue.Empty
        traceback.
        """
        if self._finished and self._queue.empty():
            return None             # exhausted on a previous call
        try:
            batch = self._queue.get(timeout=timeout)
        except queue.Empty:
            if self._finished:      # all workers already exited cleanly:
                return None         # plain exhaustion, not a stall/death
            alive = any(t.is_alive() for t in self._threads)
            state = (f"stalled (no batch within {timeout}s)" if alive
                     else "died")
            raise RuntimeError(
                f"BatchLoader worker {state}: dataset len "
                f"{len(self.dataset)}, batch_size {self.batch_size}"
            ) from self._error
        if batch is None and self._error is not None:
            raise RuntimeError(
                "BatchLoader worker died while assembling a batch"
            ) from self._error
        return batch

    def get_shape(self):
        """(top_shape, front_shape, rgb_shape) of the views."""
        return self.cfg.top_shape, self.cfg.front_shape, self.cfg.rgb_shape

    def _drain(self):
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def close(self):
        """Stop the workers and join them, for up to 10 s (draining the
        queue so that none waits on a full queue)."""
        self._stop.set()
        with self._emit_cv:
            self._emit_cv.notify_all()
        deadline = time.monotonic() + 10.0
        for t in self._threads:
            while t.is_alive() and time.monotonic() < deadline:
                self._drain()
                t.join(timeout=0.05)
        self._drain()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
