"""KITTI dataset readers: the object benchmark layout, raw drives and
odometry sequences.

Port of ``mv3d_tpu/data/kitti.py``: the same file discovery, label
parsing and :class:`Frame` records, with images read by the port's own
PNG decoder (:mod:`mv3d_tpu_torch.utils.png`) instead of PIL and the
camera-to-lidar transform and box composition on tensors
(:mod:`mv3d_tpu_torch.ops.boxes3d`).
"""

from __future__ import annotations

import glob
import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import Config, cfg as _default_cfg
from ..ops import boxes3d as box3d_ops
from ..utils.png import read_png
from . import tracklets as tracklet_io


def read_velodyne(path: str) -> np.ndarray:
    """Load a KITTI .bin scan -> (N, 4) float32 [x, y, z, reflectance]."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_image(path: str) -> np.ndarray:
    """Load a PNG image -> (H, W, 3) uint8 RGB (gray is repeated over the
    three channels and alpha dropped, as PIL's ``convert("RGB")`` does)."""
    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def kitti_label_to_lidar_box3d(label_lines: Sequence[str],
                               object_type: str = "Car",
                               positive_only: bool = True,
                               cfg: Config = _default_cfg):
    """Parse KITTI label_2 txt lines into lidar-frame 3D boxes.

    Camera (x, y, z) -> lidar through the calibration's inverse, rz = -ry
    - pi/2, categories {Car, Van} / {Pedestrian} / {Cyclist}.

    Returns (boxes3d (N, 8, 3), labels (N,)).
    """
    for cat in (["Car", "Van"], ["Pedestrian"], ["Cyclist"]):
        if object_type in cat:
            category = cat
            break
    else:
        return np.zeros((0, 8, 3), np.float32), np.zeros(0, np.int32)

    fields, labels = [], []
    for line in label_lines:
        parts = line.split()
        if not parts:
            continue
        obj = parts[0]
        if positive_only and obj not in category:
            continue
        if obj == "DontCare":
            continue
        fields.append([float(v) for v in parts[8:15]])
        labels.append(1 if obj in category else 0)
    if not fields:
        return np.zeros((0, 8, 3), np.float32), np.zeros(0, np.int32)
    # every box in one call each: the same elementwise f32 operations as
    # one box at a time
    f64 = torch.tensor(fields, dtype=torch.float64)
    centers = box3d_ops.camera_to_lidar_points(f64[:, 3:6].float(), cfg)
    rz = (-f64[:, 6] - math.pi / 2).float()
    zeros = torch.zeros_like(rz)
    boxes = box3d_ops.box3d_compose(centers, f64[:, 0:3].float(),
                                    torch.stack([zeros, zeros, rz], -1), cfg)
    return boxes.numpy(), np.asarray(labels, np.int32)


@dataclass
class Frame:
    tag: str
    points: np.ndarray            # (N, 4) lidar
    rgb: Optional[np.ndarray]     # (H, W, 3) uint8 or None
    gt_boxes3d: np.ndarray        # (G, 8, 3)
    gt_labels: np.ndarray         # (G,)


class KittiObjectDataset:
    """KITTI object benchmark layout.

    Expects ``<root>/training/{image_2,velodyne,label_2}`` plus an optional
    split file of frame tags (one per line).
    """

    def __init__(self, object_dir: str, split_file: str = "",
                 is_testset: bool = False, object_type: str = "Car",
                 cfg: Config = _default_cfg):
        self.object_dir = object_dir
        self.cfg = cfg
        self.is_testset = is_testset
        self.object_type = object_type
        sub = "testing" if is_testset else "training"

        if split_file:
            with open(split_file) as f:
                self.tags = [l.strip() for l in f if l.strip()]
        else:
            labels = sorted(glob.glob(
                os.path.join(object_dir, sub, "velodyne", "*.bin")))
            self.tags = [os.path.splitext(os.path.basename(p))[0]
                         for p in labels]
        self.sub = sub

    def __len__(self):
        return len(self.tags)

    def _p(self, kind: str, tag: str, ext: str) -> str:
        return os.path.join(self.object_dir, self.sub, kind, tag + ext)

    def load_frame(self, i: int) -> Frame:
        tag = self.tags[i]
        points = read_velodyne(self._p("velodyne", tag, ".bin"))
        rgb_path = self._p("image_2", tag, ".png")
        rgb = read_image(rgb_path) if os.path.exists(rgb_path) else None
        if self.is_testset:
            gt_boxes = np.zeros((0, 8, 3), np.float32)
            gt_labels = np.zeros(0, np.int32)
        else:
            with open(self._p("label_2", tag, ".txt")) as f:
                lines = f.readlines()
            gt_boxes, gt_labels = kitti_label_to_lidar_box3d(
                lines, self.object_type, positive_only=False, cfg=self.cfg)
        return Frame(tag=tag, points=points, rgb=rgb,
                     gt_boxes3d=gt_boxes, gt_labels=gt_labels)


class KittiRawDataset:
    """KITTI raw drive layout with tracklet gt.

    Expects ``<root>/<date>/<date>_drive_<id>_sync/{velodyne_points/data,
    image_02/data, tracklet_labels.xml}`` or, when that directory is
    absent, the Didi bag-converter layout ``<root>/<date>/<drive>/...``
    (the same subtree without the ``_sync`` naming).
    """

    def __init__(self, raw_dir: str, date: str, drive: str,
                 cfg: Config = _default_cfg):
        self.cfg = cfg
        self.date = date
        self.drive = drive
        base = os.path.join(raw_dir, date, f"{date}_drive_{drive}_sync")
        if not os.path.isdir(base):
            base = os.path.join(raw_dir, date, drive)   # didi layout
        self.base = base
        self.velo_files = sorted(glob.glob(
            os.path.join(base, "velodyne_points", "data", "*.bin")))
        self.rgb_files = sorted(glob.glob(
            os.path.join(base, "image_02", "data", "*.png")))
        self.tracklet_file = os.path.join(base, "tracklet_labels.xml")
        n = len(self.velo_files)
        if os.path.exists(self.tracklet_file):
            self.objects = tracklet_io.read_objects(
                self.tracklet_file, range(n), cfg)
        else:
            self.objects = [[] for _ in range(n)]

    def __len__(self):
        return len(self.velo_files)

    def load_frame(self, i: int) -> Frame:
        points = read_velodyne(self.velo_files[i])
        rgb = read_image(self.rgb_files[i]) if i < len(self.rgb_files) else None
        gt_boxes, gt_labels = tracklet_io.objects_to_gt_boxes3d(self.objects[i])
        tag = f"{self.date}_{self.drive}_{i:05d}"
        return Frame(tag=tag, points=points, rgb=rgb,
                     gt_boxes3d=gt_boxes, gt_labels=gt_labels)


class KittiOdometryDataset:
    """KITTI odometry benchmark layout: drive sequences with ego poses,
    through the same :class:`Frame` API.

    Expects ``<root>/sequences/<seq>/{calib.txt, times.txt, velodyne/*.bin
    [, image_2/*.png]}`` and optionally ``<root>/poses/<seq>.txt``.
    """

    def __init__(self, base_path: str, sequence: str,
                 cfg: Config = _default_cfg):
        self.cfg = cfg
        self.sequence = sequence
        self.seq_dir = os.path.join(base_path, "sequences", sequence)
        self.pose_file = os.path.join(base_path, "poses", sequence + ".txt")
        self.velo_files = sorted(glob.glob(
            os.path.join(self.seq_dir, "velodyne", "*.bin")))
        self.rgb_files = sorted(glob.glob(
            os.path.join(self.seq_dir, "image_2", "*.png")))

    def load_calib(self) -> Dict[str, np.ndarray]:
        """calib.txt -> {'P0'..'P3': (3,4) projections, 'Tr' and
        'T_cam2_velo': (4,4) velodyne->rectified-camera transforms,
        'K_cam2': (3,3) intrinsics} — the rectified cam2 extrinsic composes
        the P2 baseline shift onto Tr."""
        out = {}
        with open(os.path.join(self.seq_dir, "calib.txt")) as f:
            for line in f:
                if ":" not in line:
                    continue
                k, v = line.split(":", 1)
                out[k.strip()] = np.array(v.split(), dtype=np.float64)
        for k in ("P0", "P1", "P2", "P3"):
            if k in out:
                out[k] = out[k].reshape(3, 4)
        if "Tr" in out:
            tr = np.vstack([out["Tr"].reshape(3, 4), [0, 0, 0, 1]])
            out["Tr"] = tr
            if "P2" in out:
                t2 = np.eye(4)
                t2[0, 3] = out["P2"][0, 3] / out["P2"][0, 0]
                out["T_cam2_velo"] = t2 @ tr
                out["K_cam2"] = out["P2"][:3, :3]
        return out

    def load_poses(self) -> np.ndarray:
        """poses/<seq>.txt -> (N, 4, 4) world-from-cam0 transforms; empty
        (0, 4, 4) when ground truth is unavailable (test sequences)."""
        if not os.path.exists(self.pose_file):
            return np.zeros((0, 4, 4), np.float64)
        flat = np.loadtxt(self.pose_file, dtype=np.float64).reshape(-1, 3, 4)
        n = len(flat)
        out = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
        out[:, :3, :] = flat
        return out

    def load_timestamps(self) -> np.ndarray:
        """times.txt -> (N,) seconds (float64)."""
        return np.loadtxt(os.path.join(self.seq_dir, "times.txt"),
                          dtype=np.float64).reshape(-1)

    def __len__(self):
        return len(self.velo_files)

    def load_frame(self, i: int) -> Frame:
        points = read_velodyne(self.velo_files[i])
        rgb = read_image(self.rgb_files[i]) if i < len(self.rgb_files) else None
        return Frame(tag=f"{self.sequence}_{i:06d}", points=points, rgb=rgb,
                     gt_boxes3d=np.zeros((0, 8, 3), np.float32),
                     gt_labels=np.zeros(0, np.int32))
