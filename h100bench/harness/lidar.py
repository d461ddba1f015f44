"""The traffic's frames, drawn from the seed: ring-model lidar sweeps and
camera images.

A sweep casts one ray per (beam, azimuth step) of the configuration's
sensor (its published beam elevations and angular step) from the sensor
at ``height_m`` above a flat ground, against the scene's boxes: parked
and moving cars (upright oriented boxes standing on the ground) and
building walls along the road. A ray takes the nearest hit within
``max_range_m``; a ray with none gives no point, so the sky and the far
ground give nothing, as on a real sensor. Each return is kept with
probability ``1 - dropout``, its range takes Gaussian noise, and its
reflectance is drawn by surface (ground low, walls middle, cars high).
Points are (x, y, z, reflectance) in the sensor's frame, x forward, z up,
in scan order (beam-major, as the sensor's packets come).

Nothing is cut to the model's point bucket here: the served program
receives the whole sweep.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of ``seed`` (any integer up
    to 2**64)."""
    return np.random.Generator(np.random.PCG64([stream, seed % 2 ** 64]))


def directions(sensor: Dict[str, Any]) -> np.ndarray:
    """(beams * steps, 3) unit ray directions, beam-major."""
    el = np.radians(np.asarray(sensor["elevations_deg"], np.float64))
    steps = int(round(360.0 / sensor["azimuth_step_deg"]))
    az = np.radians(np.arange(steps) * sensor["azimuth_step_deg"])
    ce, se = np.cos(el)[:, None], np.sin(el)[:, None]
    d = np.stack([ce * np.cos(az)[None], ce * np.sin(az)[None],
                  np.broadcast_to(se, (len(el), steps))], -1)
    return d.reshape(-1, 3)


def scene(rng: np.random.Generator, grid: Dict[str, float],
          params: Dict[str, Any], height: float) -> List[Tuple]:
    """The scene's boxes as (cx, cy, yaw, length, width, tall, kind),
    standing on the ground (z = -height in the sensor's frame): between
    ``cars`` (lo, hi) cars inside the top grid, clear of the capture car,
    and ``walls`` (lo, hi) building fronts beside the road."""
    boxes = []
    lo, hi = params["cars"]
    x_lo, x_hi = grid["x_min"] + 3.0, grid["x_max"] - 3.0
    y_lo, y_hi = grid["y_min"] + 3.0, grid["y_max"] - 3.0
    n_cars = int(rng.integers(lo, hi + 1))
    while len(boxes) < n_cars:
        cx, cy = rng.uniform(x_lo, x_hi), rng.uniform(y_lo, y_hi)
        if abs(cx) < 6.0 and abs(cy) < 3.0:
            continue
        boxes.append((cx, cy, rng.uniform(-np.pi, np.pi),
                      rng.uniform(3.5, 4.8), rng.uniform(1.5, 1.9),
                      rng.uniform(1.4, 1.8), "car"))
    wlo, whi = params["walls"]
    for _ in range(int(rng.integers(wlo, whi + 1))):
        side = 1.0 if rng.random() < 0.5 else -1.0
        dist = rng.uniform(*params["wall_offset_m"])
        length = rng.uniform(*params["wall_length_m"])
        cx = rng.uniform(-60.0, 60.0)
        boxes.append((cx, side * (dist + 1.0), rng.uniform(-0.05, 0.05),
                      length, 2.0, rng.uniform(3.0, 12.0), "wall"))
    return boxes


def _box_hits(dirs: np.ndarray, box: Tuple, height: float) -> np.ndarray:
    """Distance along each ray to ``box`` (inf where it misses), the
    sensor at the origin and the box's bottom at z = -height."""
    cx, cy, yaw, length, width, tall, _ = box
    c, s = np.cos(-yaw), np.sin(-yaw)
    # the ray in the box's frame: origin o, direction d
    o = np.array([c * -cx - s * -cy, s * -cx + c * -cy, height])
    d = np.stack([c * dirs[:, 0] - s * dirs[:, 1],
                  s * dirs[:, 0] + c * dirs[:, 1], dirs[:, 2]], 1)
    lo = np.array([-length / 2, -width / 2, 0.0])
    hi = np.array([length / 2, width / 2, tall])
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo - o) / d
        t2 = (hi - o) / d
    near = np.nanmax(np.minimum(t1, t2), 1)
    far = np.nanmin(np.maximum(t1, t2), 1)
    hit = (far >= near) & (near > 0)
    return np.where(hit, near, np.inf)


def _facing(box: Tuple, steps: int, step_deg: float) -> np.ndarray:
    """The azimuth steps whose rays can reach ``box`` (all of them where
    the sensor stands inside its bounding circle)."""
    cx, cy, _, length, width, _, _ = box
    dist, rad = np.hypot(cx, cy), 0.5 * np.hypot(length, width)
    if dist <= rad:
        return np.arange(steps)
    half = np.degrees(np.arcsin(rad / dist)) + step_deg
    mid = np.degrees(np.arctan2(cy, cx))
    az = np.arange(steps) * step_deg
    off = (az - mid + 180.0) % 360.0 - 180.0
    return np.nonzero(np.abs(off) <= half)[0]


def sweep(rng: np.random.Generator, sensor: Dict[str, Any],
          grid: Dict[str, float], params: Dict[str, Any]) -> np.ndarray:
    """One sweep: (M, 4) float32 points."""
    dirs = directions(sensor)
    beams = len(sensor["elevations_deg"])
    steps = len(dirs) // beams
    height = float(sensor["height_m"])
    t = np.full(len(dirs), np.inf)
    kind = np.zeros(len(dirs), np.int8)           # 0 ground, 1 wall, 2 car
    down = dirs[:, 2] < 0
    t[down] = -height / dirs[down, 2]
    for box in scene(rng, grid, params, height):
        cols = _facing(box, steps, sensor["azimuth_step_deg"])
        rays = (np.arange(beams)[:, None] * steps + cols[None]).reshape(-1)
        tb = _box_hits(dirs[rays], box, height)
        closer = tb < t[rays]
        t[rays[closer]] = tb[closer]
        kind[rays[closer]] = 2 if box[-1] == "car" else 1
    keep = (t <= sensor["max_range_m"]) & (
        rng.random(len(dirs)) >= sensor["dropout"])
    r = t[keep] + rng.normal(0.0, sensor["range_noise_m"], int(keep.sum()))
    xyz = dirs[keep] * r[:, None]
    k = kind[keep]
    lo = np.array([0.0, 0.05, 0.1])[k]
    hi = np.array([0.35, 0.6, 0.95])[k]
    refl = lo + (hi - lo) * rng.random(len(k))
    return np.concatenate([xyz, refl[:, None]], 1).astype(np.float32)


def camera(rng: np.random.Generator, shape) -> np.ndarray:
    """One camera image at the model's (H, W, 3) rgb shape, float32 pixel
    values in [0, 255)."""
    return rng.random(tuple(shape), dtype=np.float32) * np.float32(255.0)


def frames(seed: int, n: int, sensor: Dict[str, Any],
           grid: Dict[str, float], params: Dict[str, Any], rgb_shape
           ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n`` (points, rgb) frames of one drive, the same for a seed."""
    rng = rng_for(seed, 1)
    return [(sweep(rng, sensor, grid, params), camera(rng, rgb_shape))
            for _ in range(n)]
