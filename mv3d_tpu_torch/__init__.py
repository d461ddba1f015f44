"""mv3d_tpu_torch — MV3D in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a): lidar -> 3D-boxes inference (float or int8),
serving a frozen program over HTTP, staged training from KITTI data on
disk, data parallelism over a device mesh, and evaluation.

A port of :mod:`mv3d_tpu` (the JAX/TPU package, which stays the reference).
Module names mirror it: ``config.py`` (its own copy of the config tree),
``device.py`` (where entry points run), ``ops/`` (voxelizer and its four
kernels, registered as the ``mv3d::`` operators by ``ops/library.py``,
the quantized point transfer, the int8 products, anchors, boxes, NMS,
proposals, ROI-align, detection decode), ``models/``
(trunks, subnets, ``MV3DNet`` with its training forward), ``data/`` (KITTI
readers, tracklets, host aux planes, the rgb resize, batch loader, the
offline preprocessor and its precomputed-view dataset), ``utils/`` (PNG
I/O, debug drawing without PIL, 3D and feature-map pictures without
matplotlib, MJPEG video, logger, timer, metrics and debug images,
dashboard, data checks, the cost model and profiling helpers),
``tracking/`` (UKF, multi-object tracker, the motion GRU), ``train/`` (targets, losses, augmentation,
checkpoints, the ``MV3D``, ``Predictor`` and ``Trainer`` API with its
debug mode, and the testers), ``eval/`` (the tracklet 3D-IoU scorer,
KITTI txt export), ``experiments/`` (the staged-training ``Task`` and the
experiment ``Manager``), ``parallel/`` (meshes and the sharded train and
inference steps), ``serving/`` (the ``torch.export`` serving program:
export and load), ``cli/`` (``train``, ``test``, ``tracking``,
``preprocess``, ``rehearsal``, ``dashboard``, ``export``, ``serve``,
``render`` and ``viewer``) and ``convert.py`` (flax variables <->
``state_dict``). It imports torch and numpy, and nothing of ``mv3d_tpu``,
jax, flax or matplotlib; PIL only where the JAX package uses it for what
the port does not write itself, imported when called: the JPEG frames of
``utils/video.py``, ``utils/viz3d.pngs_to_gif`` and the render command's
camera-image resize.
"""

from .config import (Config, avod_cars_config, kitti_config,  # noqa: F401
                     serving_config)
