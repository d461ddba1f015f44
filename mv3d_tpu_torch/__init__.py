"""mv3d_tpu_torch — MV3D in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a): lidar -> 3D-boxes inference (float or int8),
serving over HTTP, staged training from KITTI data on disk, data
parallelism over a device mesh, and evaluation.

A port of :mod:`mv3d_tpu` (the JAX/TPU package, which stays the reference).
Module names mirror it: ``config.py`` (its own copy of the config tree),
``ops/`` (voxelizer and its four kernels, the quantized point transfer,
the int8 products, anchors, boxes, NMS, proposals, ROI-align, detection
decode), ``models/``
(trunks, subnets, ``MV3DNet`` with its training forward), ``data/`` (KITTI
readers, tracklets, host aux planes, the rgb resize, batch loader, the
offline preprocessor and its precomputed-view dataset), ``utils/`` (PNG
I/O, debug drawing without PIL, logger, timer, metrics and debug images,
dashboard, data checks), ``train/`` (targets, losses, augmentation,
checkpoints, the ``MV3D``, ``Predictor`` and ``Trainer`` API with its
debug mode, and the testers), ``eval/`` (the tracklet 3D-IoU scorer,
KITTI txt export), ``experiments/`` (the staged-training ``Task``),
``parallel/`` (meshes and the sharded train and inference steps),
``serving/`` (artifact export and load), ``cli/`` (``train``, ``test``,
``tracking``, ``preprocess``, ``rehearsal``, ``dashboard``, ``export`` and
``serve``) and ``convert.py`` (flax variables <-> ``state_dict``). It
imports torch and numpy, and nothing of ``mv3d_tpu``, jax, flax or PIL.
"""

from .config import Config, kitti_config, serving_config  # noqa: F401
