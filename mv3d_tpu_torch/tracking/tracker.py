"""SORT-style multi-object tracker over per-frame 3D detections.

The port's copy of ``mv3d_tpu/tracking/tracker.py``: a clean-room
equivalent of the reference's offline SORT/Kalman trackers (utils/kalman/,
utils/bag_to_kitti fusion tooling): greedy BEV-IoU/distance association +
per-track CTRV UKF smoothing. Operates on host numpy: this is
post-processing, not the device's hot path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from .ukf import UnscentedKalmanFilter


@dataclass
class Track:
    track_id: int
    ukf: UnscentedKalmanFilter
    size: np.ndarray                  # (h, w, l) running estimate
    yaw: float
    hits: int = 1
    missed: int = 0
    history: List[np.ndarray] = field(default_factory=list)

    @property
    def position(self) -> np.ndarray:
        return self.ukf.x[0:2]


class MultiObjectTracker:
    """Greedy nearest-neighbour association with gating + UKF smoothing.

    Detections per frame: (translations (N, 3), sizes (N, 3), yaws (N,)).
    """

    def __init__(self, dt: float = 0.1, gate_distance: float = 2.5,
                 max_missed: int = 3, min_hits: int = 2):
        self.dt = dt
        self.gate = gate_distance
        self.max_missed = max_missed
        self.min_hits = min_hits
        self.tracks: List[Track] = []
        self._next_id = 0

    def _new_track(self, trans, size, yaw) -> Track:
        ukf = UnscentedKalmanFilter()
        ukf.init_from_measurement(trans[0], trans[1])
        t = Track(self._next_id, ukf, np.asarray(size, float), float(yaw))
        t.history.append(np.asarray(trans, float))
        self._next_id += 1
        return t

    def update(self, translations, sizes, yaws) -> List[Track]:
        """Advance one frame; returns confirmed tracks."""
        translations = np.asarray(translations, float).reshape(-1, 3)
        sizes = np.asarray(sizes, float).reshape(-1, 3)
        yaws = np.asarray(yaws, float).reshape(-1)

        # predict all tracks forward
        for t in self.tracks:
            t.ukf.predict(self.dt)

        # greedy association by BEV distance
        unmatched_dets = set(range(len(translations)))
        unmatched_tracks = set(range(len(self.tracks)))
        pairs = []
        for ti, t in enumerate(self.tracks):
            for di in range(len(translations)):
                d = np.linalg.norm(t.position - translations[di][0:2])
                if d < self.gate:
                    pairs.append((d, ti, di))
        for d, ti, di in sorted(pairs):
            if ti in unmatched_tracks and di in unmatched_dets:
                unmatched_tracks.remove(ti)
                unmatched_dets.remove(di)
                t = self.tracks[ti]
                t.ukf.update_lidar(translations[di][0:2])
                t.size = 0.7 * t.size + 0.3 * sizes[di]
                t.yaw = float(yaws[di])
                t.hits += 1
                t.missed = 0
                t.history.append(translations[di].copy())

        for ti in unmatched_tracks:
            self.tracks[ti].missed += 1
        for di in unmatched_dets:
            self.tracks.append(self._new_track(
                translations[di], sizes[di], yaws[di]))

        self.tracks = [t for t in self.tracks if t.missed <= self.max_missed]
        return [t for t in self.tracks if t.hits >= self.min_hits]
