"""mv3d_tpu_torch — the MV3D lidar -> 3D-boxes inference path in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of :mod:`mv3d_tpu` (the JAX/TPU package, which stays the reference).
Module names mirror it: ``ops/`` (voxelizer and its sweep kernel, anchors,
boxes, NMS, proposals, ROI-align, detection decode), ``models/`` (trunks,
subnets, ``MV3DNet``), ``train/trainer.py`` (the ``MV3D`` inference API)
and ``convert.py`` (flax variables -> ``state_dict``). It imports torch and
never jax; the only ``mv3d_tpu`` module it uses is the numpy-only
``mv3d_tpu.config``.
"""

from mv3d_tpu.config import Config, kitti_config  # noqa: F401
