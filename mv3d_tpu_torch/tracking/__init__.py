"""Offline multi-object tracking: CTRV UKF + greedy association (numpy
copies of ``mv3d_tpu/tracking/{ukf,tracker}.py``), and the learned
motion model (``seq_model``: a GRU over box trajectories)."""

from .ukf import UnscentedKalmanFilter  # noqa: F401
from .tracker import Track, MultiObjectTracker  # noqa: F401
