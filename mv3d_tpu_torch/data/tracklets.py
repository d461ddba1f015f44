"""Tracklet XML I/O: writer, parser and per-frame gt expansion.

Port of ``mv3d_tpu/data/tracklets.py`` (numpy and ``xml.etree``):

  * :func:`write_tracklets` writes the boost-serialization XML dialect of
    KITTI's ``tracklet_labels.xml``, which the evaluators read;
  * :class:`TrackletSaver` collects single-pose detections, keeping only
    those with ``0 < ty < 8``;
  * :func:`parse_tracklets` reads a gt or predicted file;
  * :func:`read_objects` expands tracklets into per-frame 8-corner lidar
    boxes, with the KITTI truncation filter and the Car/Van/Truck/Tram
    class gate; :func:`objects_to_gt_boxes3d` turns them into gt arrays.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..config import Config, cfg as _default_cfg

# truncation states (pykitti/tracklet.py)
TRUNC_UNSET = -1
TRUNC_IN_IMAGE = 0
TRUNC_TRUNCATED = 1
TRUNC_OUT_IMAGE = 2
TRUNC_BEHIND_IMAGE = 3

GT_CLASSES = ("Van", "Truck", "Car", "Tram")


@dataclass
class Tracklet:
    object_type: str
    h: float
    w: float
    l: float
    first_frame: int = 0
    # each pose: dict with tx ty tz rx ry rz (+ optional state/occlusion/...)
    poses: List[Dict[str, float]] = field(default_factory=list)

    @property
    def n_frames(self) -> int:
        return len(self.poses)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _writeln(f, s, tabs):
    f.write("\t" * tabs + s + "\n")


def _write_tracklet(f, t: Tracklet, class_id: int, tabs: int):
    _writeln(f, f'<item class_id="{class_id}" tracking_level="0" version="1">', tabs)
    tabs += 1
    class_id += 1
    _writeln(f, f"<objectType>{t.object_type}</objectType>", tabs)
    _writeln(f, "<h>{:.16f}</h>".format(t.h), tabs)
    _writeln(f, "<w>{:.16f}</w>".format(t.w), tabs)
    _writeln(f, "<l>{:.16f}</l>".format(t.l), tabs)
    _writeln(f, f"<first_frame>{t.first_frame}</first_frame>", tabs)
    _writeln(f, f'<poses class_id="{class_id}" tracking_level="0" version="0">', tabs)
    class_id += 1
    tabs += 1
    _writeln(f, f"<count>{len(t.poses)}</count>", tabs)
    _writeln(f, "<item_version>2</item_version>", tabs)
    first = True
    for p in t.poses:
        if first:
            _writeln(f, f'<item class_id="{class_id}" tracking_level="0" version="2">', tabs)
            first = False
        else:
            _writeln(f, "<item>", tabs)
        tabs += 1
        class_id += 1
        for k in ("tx", "ty", "tz", "rx", "ry", "rz"):
            _writeln(f, "<{0}>{1:.16f}</{0}>".format(k, p[k]), tabs)
        _writeln(f, "<state>1</state>", tabs)
        _writeln(f, "<occlusion>-1</occlusion>", tabs)
        _writeln(f, "<occlusion_kf>-1</occlusion_kf>", tabs)
        _writeln(f, "<truncation>-1</truncation>", tabs)
        _writeln(f, "<amt_occlusion>0.0</amt_occlusion>", tabs)
        _writeln(f, "<amt_occlusion_kf>-1</amt_occlusion_kf>", tabs)
        _writeln(f, "<amt_border_l>0.0</amt_border_l>", tabs)
        _writeln(f, "<amt_border_r>0.0</amt_border_r>", tabs)
        _writeln(f, "<amt_border_kf>-1</amt_border_kf>", tabs)
        tabs -= 1
        _writeln(f, "</item>", tabs)
    tabs -= 1
    _writeln(f, "</poses>", tabs)
    _writeln(f, "<finished>1</finished>", tabs)
    tabs -= 1
    _writeln(f, "</item>", tabs)


def write_tracklets(path: str, tracklets: Sequence[Tracklet]):
    with open(path, "w") as f:
        _writeln(f, r'<?xml version="1.0" encoding="UTF-8" standalone="yes" ?>', 0)
        _writeln(f, r"<!DOCTYPE boost_serialization>", 0)
        _writeln(f, r'<boost_serialization signature="serialization::archive" version="9">', 0)
        _writeln(f, r'<tracklets class_id="0" tracking_level="0" version="0">', 0)
        _writeln(f, f"<count>{len(tracklets)}</count>", 1)
        _writeln(f, "<item_version>1</item_version> ", 1)
        for t in tracklets:
            _write_tracklet(f, t, 1, 1)
        _writeln(f, "</tracklets>", 0)
        _writeln(f, "</boost_serialization> ", 0)


class TrackletSaver:
    """Accumulates single-pose detections and writes
    ``tracklet_labels_pred.xml``."""

    def __init__(self, dir_path: str, gate_ty: bool = True,
                 overwrite: bool = True):
        os.makedirs(dir_path, exist_ok=True)
        self.path = os.path.join(dir_path, "tracklet_labels_pred.xml")
        if os.path.isfile(self.path) and not overwrite:
            raise FileExistsError(self.path)
        self.tracklets: List[Tracklet] = []
        self.gate_ty = gate_ty

    def add_tracklet(self, first_frame: int, size, translation, rotation):
        """size = (h, w, l); kept only where 0 < ty < 8."""
        if self.gate_ty and not (0 < translation[1] < 8):
            return
        t = Tracklet(object_type="Car", h=float(size[0]), w=float(size[1]),
                     l=float(size[2]), first_frame=int(first_frame))
        t.poses = [{"tx": float(translation[0]), "ty": float(translation[1]),
                    "tz": float(translation[2]), "rx": float(rotation[0]),
                    "ry": float(rotation[1]), "rz": float(rotation[2])}]
        self.tracklets.append(t)

    def write_tracklet(self):
        write_tracklets(self.path, self.tracklets)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

def parse_tracklets(path: str) -> List[Tracklet]:
    """Parse a KITTI tracklet_labels.xml (gt or predicted)."""
    root = ET.parse(path).getroot()
    tr_node = root.find("tracklets")
    out: List[Tracklet] = []
    for item in tr_node.findall("item"):
        t = Tracklet(
            object_type=item.findtext("objectType"),
            h=float(item.findtext("h")),
            w=float(item.findtext("w")),
            l=float(item.findtext("l")),
            first_frame=int(item.findtext("first_frame")))
        poses = item.find("poses")
        for p in poses.findall("item"):
            pose = {k: float(p.findtext(k))
                    for k in ("tx", "ty", "tz", "rx", "ry", "rz")}
            for k in ("state", "occlusion", "truncation"):
                v = p.findtext(k)
                pose[k] = float(v) if v is not None else -1.0
            t.poses.append(pose)
        out.append(t)
    return out


# ---------------------------------------------------------------------------
# per-frame gt expansion
# ---------------------------------------------------------------------------

@dataclass
class FrameObject:
    box: np.ndarray          # (8, 3) lidar corners
    type: str
    tracklet_id: int
    translation: np.ndarray
    rotation: np.ndarray
    size: np.ndarray         # (h, w, l)


def _tracklet_box(h, w, l, cfg: Config) -> np.ndarray:
    if cfg.dataset_type in ("didi", "didi2", "test"):
        h, w = h * 1.1, l
        zs = [-h / 2] * 4 + [h / 2] * 4
    else:
        zs = [0.0] * 4 + [h] * 4
    return np.array([
        [-l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2],
        [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2],
        zs])


def read_objects(tracklet_file: str, frames_index: Sequence[int],
                 cfg: Config = _default_cfg) -> List[List[FrameObject]]:
    """Expand tracklets into per-frame lists of gt objects.

    KITTI frames keep only
    in-image/truncated objects; only Car/Van/Truck/Tram classes survive.
    """
    frames_index = list(frames_index)
    objects: List[List[FrameObject]] = [[] for _ in frames_index]
    tracklets = parse_tracklets(tracklet_file)

    for n, t in enumerate(tracklets):
        box0 = _tracklet_box(t.h, t.w, t.l, cfg)
        start = t.first_frame
        for fi in frames_index:
            i = fi - start
            if not (0 <= i < t.n_frames):
                continue
            pose = t.poses[i]
            if cfg.dataset_type == "kitti" and pose.get("truncation", -1) not \
                    in (TRUNC_IN_IMAGE, TRUNC_TRUNCATED):
                continue
            if t.object_type not in GT_CLASSES:
                continue
            yaw = pose["rz"]
            rot = np.array([[np.cos(yaw), -np.sin(yaw), 0.0],
                            [np.sin(yaw), np.cos(yaw), 0.0],
                            [0.0, 0.0, 1.0]])
            trans = np.array([pose["tx"], pose["ty"], pose["tz"]])
            corners = (rot @ box0 + trans[:, None]).T
            objects[frames_index.index(fi)].append(FrameObject(
                box=corners.astype(np.float32), type=t.object_type,
                tracklet_id=n, translation=trans,
                rotation=np.array([pose["rx"], pose["ry"], pose["rz"]]),
                size=np.array([t.h, t.w, t.l])))
    return objects


def objects_to_gt_boxes3d(objs: Sequence[FrameObject]
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame objects -> (gt_boxes3d (N,8,3), gt_labels (N,))."""
    num = len(objs)
    boxes = np.zeros((num, 8, 3), np.float32)
    labels = np.zeros(num, np.int32)
    for i, o in enumerate(objs):
        boxes[i] = o.box
        labels[i] = 1 if o.type in GT_CLASSES else 0
    return boxes, labels
