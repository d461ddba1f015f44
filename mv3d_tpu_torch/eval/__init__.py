"""Evaluation: tracklet 3D-IoU scoring and KITTI-format export."""

from .tracklet_eval import tracklet_score  # noqa: F401
from .kitti_export import export_kitti_detections  # noqa: F401
