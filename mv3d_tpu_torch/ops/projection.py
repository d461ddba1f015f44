"""Camera projection with lens distortion (the didi capture vehicle).

Port of ``mv3d_tpu/ops/projection.py``: the didi camera's calibration
(``DIDI_CAMERA_MATRIX``, ``DIDI_DIST_COEFFS``), the calibrated 3x4
lidar -> image projection the didi rgb path uses (``DIDI_PROJ_MAT``,
read by :func:`mv3d_tpu_torch.ops.boxes3d.box3d_to_rgb_box`) and
``CameraModel``: a pinhole projection with radial (k1, k2, k3) and
tangential (p1, p2) distortion, and its inverse by fixed-point
iteration. Tensors in f32 on the points' device; the 3x3 rotation is
summed in index order (:func:`mv3d_tpu_torch.ops.boxes3d._affine`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

DIDI_CAMERA_MATRIX = np.array([
    [1384.621562, 0.000000, 625.888005],
    [0.000000, 1393.652271, 559.626310],
    [0.000000, 0.000000, 1.000000]])
DIDI_DIST_COEFFS = np.array([-0.152089, 0.270168, 0.003143, -0.005640, 0.0])

DIDI_PROJ_MAT = np.array([
    [6.24391515e+02, -1.35999541e+03, -3.47685065e+01, -8.19238784e+02],
    [5.20528665e+02, 1.80893752e+01, -1.38839738e+03, -1.17506110e+03],
    [9.99547104e-01, 3.36246424e-03, -2.99045429e-02, -1.34871685e+00]])


@dataclass
class CameraModel:
    """Pinhole + distortion camera: ``project(points)`` -> pixel coords."""
    camera_matrix: np.ndarray = field(
        default_factory=lambda: DIDI_CAMERA_MATRIX.copy())
    extrinsic: np.ndarray = field(default_factory=lambda: np.eye(4))
    dist_coeffs: np.ndarray = field(
        default_factory=lambda: DIDI_DIST_COEFFS.copy())

    def _constants(self, like: torch.Tensor):
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=like.device)
        return f32(self.camera_matrix), f32(self.dist_coeffs)

    def project(self, points: torch.Tensor) -> torch.Tensor:
        """(..., 3) world points -> (..., 2) distorted pixel coordinates."""
        from .boxes3d import _affine
        points = points.to(torch.float32)
        e = torch.as_tensor(np.asarray(self.extrinsic, np.float32),
                            device=points.device)
        k, d = self._constants(points)
        cam = _affine(points, e[0:3, 0:3].T) + e[0:3, 3]
        x1 = cam[..., 0] / cam[..., 2]
        y1 = cam[..., 1] / cam[..., 2]
        r2 = x1 * x1 + y1 * y1
        factor = 1.0 + d[0] * r2 + d[1] * r2 ** 2 + d[4] * r2 ** 3
        x2 = x1 * factor + 2 * d[2] * x1 * y1 + d[3] * (r2 + 2 * x1 * x1)
        y2 = y1 * factor + d[2] * (r2 + 2 * y1 * y1) + 2 * d[3] * x1 * y1
        u = k[0, 0] * x2 + k[0, 2]
        v = k[1, 1] * y2 + k[1, 2]
        return torch.stack([u, v], dim=-1)

    def distortion_correct(self, pixels: torch.Tensor,
                           iterations: int = 5) -> torch.Tensor:
        """Invert the distortion of (..., 2) pixels by ``iterations``
        fixed-point steps."""
        pixels = pixels.to(torch.float32)
        k, d = self._constants(pixels)
        x = (pixels[..., 0] - k[0, 2]) / k[0, 0]
        y = (pixels[..., 1] - k[1, 2]) / k[1, 1]
        x0, y0 = x, y
        for _ in range(iterations):
            r2 = x * x + y * y
            factor = 1.0 + d[0] * r2 + d[1] * r2 ** 2 + d[4] * r2 ** 3
            dx = 2 * d[2] * x * y + d[3] * (r2 + 2 * x * x)
            dy = d[2] * (r2 + 2 * y * y) + 2 * d[3] * x * y
            x = (x0 - dx) / factor
            y = (y0 - dy) / factor
        u = k[0, 0] * x + k[0, 2]
        v = k[1, 1] * y + k[1, 2]
        return torch.stack([u, v], dim=-1)
