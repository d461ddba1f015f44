"""The traffic's generator: the same seed gives the same frames, the
sweeps' raw counts are those of the sensors the configurations name, and
nothing is cut to the model's bucket."""

from __future__ import annotations

import numpy as np
import pytest

from h100bench_tiny import ROOT
from harness import lidar, spec

BENCH = spec.load_benchmark(ROOT)
MIX = spec.load_mix("serve-b8")
# raw points a sweep: KITTI's HDL-64E ~100k-130k (Geiger et al. 2013),
# the HDL-32E ~55k-70k
RANGES = {"kitti": (100_000, 130_000), "didi2": (50_000, 70_000)}


@pytest.mark.parametrize("name", sorted(RANGES))
def test_sweeps_are_seeded_and_sized_as_the_sensor(name):
    config = spec.load_config(BENCH, name, ROOT)
    grid = config["config"]["top"]
    shape = (4, 6, 3)
    a = lidar.frames(2 ** 31 + 11, 3, config["sensor"], grid, MIX["scene"],
                     shape)
    b = lidar.frames(2 ** 31 + 11, 3, config["sensor"], grid, MIX["scene"],
                     shape)
    c = lidar.frames(2 ** 63 + 5, 3, config["sensor"], grid, MIX["scene"],
                     shape)
    for (pa, ra), (pb, rb) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ra, rb)
    assert not np.array_equal(a[0][0][:100], c[0][0][:100])
    lo, hi = RANGES[name]
    for pts, rgb in a + c:
        assert pts.dtype == np.float32 and pts.shape[1] == 4
        assert lo <= len(pts) <= hi, len(pts)
        assert rgb.shape == shape and rgb.dtype == np.float32
        assert 0.0 <= rgb.min() and rgb.max() < 255.0
        r = np.hypot(pts[:, 0], pts[:, 1])
        assert r.max() <= config["sensor"]["max_range_m"] + 1.0
        assert (pts[:, 3] >= 0).all() and (pts[:, 3] <= 1).all()


def test_rays_hit_the_nearest_surface():
    """A box straight ahead shadows the ground behind it; the ground's
    returns lie at the sensor's height below it."""
    sensor = {"elevations_deg": [-10.0], "azimuth_step_deg": 90.0,
              "height_m": 2.0, "max_range_m": 120.0, "dropout": 0.0,
              "range_noise_m": 0.0}
    dirs = lidar.directions(sensor)
    ground = -2.0 / dirs[:, 2]
    np.testing.assert_allclose(ground * dirs[:, 2], -2.0)
    box = (5.0, 0.0, 0.0, 2.0, 2.0, 3.0, "car")
    t = lidar._box_hits(dirs, box, 2.0)
    assert np.isclose(t[0] * dirs[0, 0], 4.0) and np.isinf(t[1:]).all()
    assert len(lidar._facing(box, 4, 90.0)) >= 1
