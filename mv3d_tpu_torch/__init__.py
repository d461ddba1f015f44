"""mv3d_tpu_torch — MV3D in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a): lidar -> 3D-boxes inference, serving over HTTP and
staged training from KITTI data on disk.

A port of :mod:`mv3d_tpu` (the JAX/TPU package, which stays the reference).
Module names mirror it: ``config.py`` (its own copy of the config tree),
``ops/`` (voxelizer and its four kernels, the quantized point transfer,
anchors, boxes, NMS, proposals, ROI-align, detection decode), ``models/``
(trunks, subnets, ``MV3DNet`` with its training forward), ``data/`` (KITTI
readers, tracklets, host aux planes, the rgb resize, batch loader),
``utils/`` (PNG I/O, logger, timer, metrics, dashboard, data checks),
``train/`` (targets, losses, augmentation, checkpoints, the ``MV3D``,
``Predictor`` and ``Trainer`` API), ``serving/`` (artifact export and
load), ``cli/`` (``train``, ``export`` and ``serve``) and ``convert.py``
(flax variables <-> ``state_dict``). It imports torch and numpy, and
nothing of ``mv3d_tpu``, jax or flax.
"""

from .config import Config, kitti_config, serving_config  # noqa: F401
