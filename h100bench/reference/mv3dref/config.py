"""Configuration of the PyTorch port: the JAX package's config tree, copied.

A copy of ``mv3d_tpu/config.py`` (the frozen dataclasses, the presets, the
KITTI calibration matrices and the dotted/yaml overrides), so the port
imports nothing of ``mv3d_tpu``: the machine that runs it on the card has
no JAX. Field names, defaults and presets are the JAX package's, so one
set of overrides builds the same configuration in both packages (the
parity tests convert a JAX ``Config`` into this one field by field).
Numpy-only.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# KITTI calibration constants (reference src/config.py:192-213)
# ---------------------------------------------------------------------------

KITTI_MATRIX_Mt = np.array(
    [[2.34773698e-04, 1.04494074e-02, 9.99945389e-01, 0.00000000e+00],
     [-9.99944155e-01, 1.05653536e-02, 1.24365378e-04, 0.00000000e+00],
     [-1.05634778e-02, -9.99889574e-01, 1.04513030e-02, 0.00000000e+00],
     [5.93721868e-02, -7.51087914e-02, -2.72132796e-01, 1.00000000e+00]],
    dtype=np.float64)

KITTI_MATRIX_Kt = np.array(
    [[721.5377, 0.0, 0.0],
     [0.0, 721.5377, 0.0],
     [609.5593, 172.854, 1.0]], dtype=np.float64)

KITTI_MATRIX_T_VELO_2_CAM = np.array(
    [[7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03],
     [1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02],
     [9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01],
     [0.0, 0.0, 0.0, 1.0]], dtype=np.float64)

KITTI_MATRIX_R_RECT_0 = np.eye(4, dtype=np.float64)


# ---------------------------------------------------------------------------
# BEV ("top") grid geometry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TopGrid:
    """Bird's-eye-view voxel grid bounds / resolution.

    Mirrors the reference module-level constants ``TOP_{X,Y,Z}_{MIN,MAX}`` and
    ``TOP_{X,Y,Z}_DIVISION`` (reference src/config.py:154-189).
    """
    x_min: float = 0.0
    x_max: float = 80.0
    y_min: float = -30.0
    y_max: float = 30.0
    z_min: float = -4.2
    z_max: float = 0.8
    x_div: float = 0.1
    y_div: float = 0.1
    z_div: float = 0.2

    # Derived sizes — exact integer arithmetic of reference src/data.py:327-332.
    @property
    def xn(self) -> int:
        return int((self.x_max - self.x_min) // self.x_div) + 1

    @property
    def yn(self) -> int:
        return int((self.y_max - self.y_min) // self.y_div) + 1

    @property
    def zn(self) -> int:
        return int((self.z_max - self.z_min) / self.z_div)

    @property
    def channels(self) -> int:
        # zn height slices + intensity + density (reference src/data.py:332)
        return self.zn + 2

    @property
    def shape(self) -> Tuple[int, int, int]:
        """(H, W, C) of the top view map. H indexes lidar x, W indexes lidar y."""
        return (self.xn, self.yn, self.channels)


@dataclass(frozen=True)
class FrontGrid:
    """Cylindrical front-view geometry (reference src/config.py:32-42)."""
    angular_res: float = 0.08 / 180.0 * math.pi
    vertical_res: float = 0.4 / 180.0 * math.pi
    velodyne_height: float = 1.73
    c_offset: int = 750
    r_offset: int = 70
    c_min: int = -750
    c_max: int = 750
    r_min: int = -70
    r_max: int = 30
    width: int = 1500
    height: int = 100

    @property
    def shape(self) -> Tuple[int, int, int]:
        # (width, height, 3 channels) — note the reference keeps (W, H, C) order
        # (src/data.py:103,168).
        return (self.width, self.height, 3)


# ---------------------------------------------------------------------------
# RPN / RCNN hyper-parameters (reference src/net/configuration.py)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RpnConfig:
    batch_size: int = 256          # RPN_BATCHSIZE
    fg_fraction: float = 0.25      # RPN_FG_FRACTION
    fg_thresh_lo: float = 0.5      # RPN_FG_THRESH_LO
    bg_thresh_hi: float = 0.3      # RPN_BG_THRESH_HI
    nms_thresh: float = 0.5        # cfg.RPN_NMS_THRESHOLD (config.py:63)
    nms_min_size: float = 8.0      # RPN_NMS_MIN_SIZE
    nms_pre_topn: int = 1000       # RPN_NMS_PRE_TOPN
    nms_post_topn: int = 30        # RPN_NMS_POST_TOPN


@dataclass(frozen=True)
class RcnnConfig:
    batch_size: int = 128          # RCNN_BATCH_SIZE
    fg_fraction: float = 0.25      # RCNN_FG_FRACTION
    fg_thresh_lo: float = 0.5      # RCNN_FG_THRESH_LO
    bg_thresh_hi: float = 0.01     # RCNN_BG_THRESH_HI
    bg_thresh_lo: float = 0.0      # RCNN_BG_THRESH_LO
    nms_thresh: float = 0.001      # final NMS threshold (rcnn_nms_op.py:62)
    score_threshold: float = 0.75  # default predict() score threshold (mv3d.py:272)


# ---------------------------------------------------------------------------
# Model / pipeline configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    num_class: int = 2                 # including background (mv3d.py:174)
    # MV3D car anchor bases in top-view pixels (mv3d.py:186-191)
    bases: Tuple[Tuple[float, float, float, float], ...] = (
        (4.5, 2.5, 10.5, 12.5),
        (2.5, 4.5, 12.5, 10.5),
        (-0.5, -12.0, 15.5, 27.0),
        (-12.0, -0.5, 27.0, 15.5),
    )
    rpn_stride: int = 8                # resnet_tiny stride (mv3d_net.py:121)
    rcnn_stride: int = 2               # after x4 upsample (mv3d_net.py:134-136)
    rgb_stride: int = 4                # resnet stride 8, x2 upsample (mv3d_net.py:267-269)
    front_stride: int = 2              # resnet stride 8, x4 upsample (mv3d_net.py:454-456)
    roi_pool_size: Tuple[int, int] = (6, 6)   # cfg.ROI_POOLING_{HEIGHT,WIDTH}
    use_front: bool = False            # cfg.USE_FRONT (deprecated in reference)
    use_top_only: bool = False         # cfg.USE_TOP_ONLY
    use_handcraft_fusion: bool = False
    use_learnable_fusion: bool = False
    # siamese context-aware refinement: a second ROI pooled from an enlarged
    # box through a twin tower, concatenated per view
    # (cfg.USE_SIAMESE_FUSION / cfg.ROI_ENLARGE_RATIO, mv3d_net.py:535-599)
    use_siamese_fusion: bool = False
    roi_enlarge_ratio: float = 1.5
    high_score_threshold: float = 0.9  # cfg.HIGH_SCORE_THRESHOLD
    # fixed z extent used to lift top boxes to 3d (config.py:43-44)
    box3d_z_min: float = -2.3
    box3d_z_max: float = 1.5
    compute_dtype: str = "bfloat16"    # MXU-friendly conv/matmul dtype
    # "int8": serving-time dynamic post-training quantization of the trunk /
    # ROI-tower / fusion-FC matmuls (ops/quantized.py — per-channel int8
    # weights quantized from the float checkpoint at each call, per-tensor
    # dynamic activations, int32 sums by torch._int_mm). Stems and
    # prediction heads stay float; training steps always run the float
    # forward (identical param tree, no checkpoint or recipe changes).
    quant: str = "none"                # "none" | "int8"
    # TPU performance options (capability-preserving deviations from the
    # reference's graph — see models/backbone.py and models/mv3d_net.py):
    #  * upsample_features=True restores the reference's trainable bilinear
    #    deconv before ROI pooling (mv3d_net.py:134-136); False (default)
    #    ROI-aligns the stride-8 maps directly — same information, no 31MB
    #    intermediate.
    #  * stem_space_to_depth folds the input's 2x2 (top) / 4x4 (rgb) spatial
    #    blocks into channels before the first conv so the stem runs with
    #    MXU-aligned channel counts instead of 27/3-channel 7x7 convs.
    upsample_features: bool = False
    stem_space_to_depth: bool = True
    #  * roi_align_impl="matmul" re-expresses the bilinear ROI-align as
    #    separable weight-matrix einsums on the MXU instead of XLA gathers
    #    (ops/roi_align.py roi_align_matmul; measured 0.38 ms/frame of
    #    gather time on the 6-view align at batch 32, round 5). Identical
    #    numerics for in-range taps; edge-touching ROIs clamp instead of
    #    extrapolating.
    roi_align_impl: str = "gather"              # "gather" | "matmul"
    # backbone ablation surface (reference ResnetBuilder family
    # resnet.py:185-258 and the VGG rgb trunk mv3d_net.py:214-252,
    # cfg.RGB_BASENET config.py:63). Live defaults match resnet_tiny.
    rgb_basenet: str = "resnet"                 # "resnet" | "vgg"
    backbone_block: str = "bottleneck"          # "bottleneck" | "basic"
    backbone_repetitions: Tuple[int, ...] = (3, 4)   # stride 4*2^(len-1)

    def pool_stride(self, view: str) -> int:
        """Effective feature stride ROI pooling sees for a view."""
        if self.upsample_features:
            return {"top": self.rcnn_stride, "rgb": self.rgb_stride,
                    "front": self.front_stride}[view]
        return self.rpn_stride


@dataclass(frozen=True)
class PipelineConfig:
    """Static shape budget for the jitted pipeline (everything padded/masked).

    ``max_points`` sizes the padded on-device point buffer. The loader crops
    to the BEV bounds on the host first (the voxelizer's own first step, so
    semantics are unchanged), which leaves ~55-65k points for a typical KITTI
    scan — 65536 covers it with headroom while halving the voxelizer's
    scatter volume vs a raw-scan-sized buffer. Raise it (e.g. to 131072) for
    denser sensors.
    """
    max_points: int = 65536            # padded, host-cropped point budget
    # compute the BEV intensity/density channels on the host (native C++ in
    # the prefetch loader, overlapped with device compute) while the TPU does
    # the 25 height channels in-graph. False = everything on device.
    host_aux_channels: bool = True
    # serving transfer diet: the loader ships uint16 fixed-point xyz + uint8
    # reflectance (7 bytes/point vs 16) and the device dequantizes in-graph
    # (ops/quantize.py — documented sub-mm deviation). f32 stays the default
    # bit-parity path.
    stream_quantized: bool = False
    # use the Pallas sorted-segment kernel (ops/voxelize_pallas.py) for the
    # height-channel scatter: ~7% faster end-to-end on TPU v5e. Off by
    # default because the kernel runs in (slow) interpret mode on CPU.
    use_pallas_heights: bool = False
    # pure-device mode: compute heights + intensity + density in ONE fused
    # Pallas sweep over the sorted points (ops/voxelize_pallas.py
    # scatter_top_fused), replacing three XLA scatters. Off by default for
    # the same CPU-interpret reason.
    use_pallas_fused: bool = False
    # how the fused sweep groups points by output tile: "sort" (full
    # lax.sort — fastest measured: 101.6 fps e2e) or "bin" (counting
    # permutation; measured SLOWER, 80-90 fps — the permutation placement
    # itself hits TPU's per-element scatter/gather serialization)
    voxel_order: str = "sort"
    # inner-loop body of the fused sweep: "rmw" (per-point VMEM
    # read-modify-writes, the round-2 kernel) or "regcache" (loop-carried
    # vreg accumulators flushed on block transitions). Measured on v5e
    # round 3: rmw is FASTER e2e (the regcache variants' two branches per
    # point cost more than the saved VMEM traffic) — see docs/PALLAS_NOTES.md
    sweep_kernel: str = "rmw"
    # dtype of the assembled top view on the fused in-graph path:
    # "float32" (oracle-exact, default) or "bfloat16" (serving: the trunks
    # convert to bf16 anyway, so the network sees identical values while the
    # kernel skips the f32->bf16 convert + assembly pass, ~0.85 ms/frame)
    top_view_dtype: str = "float32"
    # layout of the fused in-graph top view: "hwc" (standard (H, W, Zn+2),
    # default), "s2d2" ((H/2, W/2, (Zn+2)*4) folded 2x2 space-to-depth), or
    # "s2d2p" (lane-padded fold: a (heights (H/2, W2P, 128), aux (H/2, W2P,
    # 8)) PAIR whose heights plane is the fused kernel's block output
    # bitcast — zero relayout — consumed by ResnetTiny's split stem; needs
    # 4*Zn <= 128). Folded layouts require the trunk's stem_space_to_depth
    # and even grid dims; see ops/voxelize.fold_view_s2d2 / fold_view_s2d2p
    view_layout: str = "hwc"
    max_gt: int = 32                   # padded ground-truth boxes per frame
    remove_empty_thresh: float = 0.0   # cfg.REMOVE_THRES
    detect_classes: Tuple[str, ...] = ("Car", "Van")   # cfg.DETECT_OBJ


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 0.001                  # train.py default
    batch_size: int = 1                # per-device batch
    # full-net loss mix w1*(w2*top_cls + w3*top_reg) + w4*fuse_cls + w5*fuse_reg
    # (mv3d.py:824-829)
    loss_weights: Tuple[float, float, float, float, float] = (1.0, 1.0, 0.05, 1.0, 0.1)
    ckpt_every: int = 1000             # ckpt_save_step (mv3d.py:992)
    validation_every: int = 10         # validation_step (mv3d.py:991)
    summary_every: int = 200           # summary_step

    # -- learning-rate schedule (the reference trains constant Adam 1e-3,
    # mv3d.py:757,849; with real batching a warmup+cosine schedule is the
    # standard TPU improvement — "constant" preserves reference behavior)
    lr_schedule: str = "constant"      # "constant" | "cosine"
    warmup_steps: int = 0              # linear warmup 0 -> lr
    decay_steps: int = 100_000         # cosine horizon (lr_schedule="cosine")
    lr_end_factor: float = 0.01        # final lr = lr * lr_end_factor

    # -- data augmentation (absent in the reference; the MV3D paper trains
    # with per-frame flips and global yaw rotations). Applied IN-GRAPH to
    # raw points + gt corners before voxelization, training steps only, and
    # only for raw-point batches (precomputed views cannot be re-voxelized).
    aug_flip_prob: float = 0.0         # P(mirror y -> -y)
    aug_rotate_rad: float = 0.0        # global yaw ~ U(-a, a) about z

    # -- memory/stability knobs (absent in the reference) -------------------
    # remat: rematerialize the three feature trunks in the backward pass
    # (jax.checkpoint) — trades one extra trunk forward for not storing the
    # full-resolution BEV/RGB/front conv activations, the dominant training
    # HBM cost; enables ~2x larger train batches per chip.
    remat: bool = False
    # global-norm gradient clipping applied to the trained subnets before
    # Adam (0 = off, reference behavior).
    grad_clip_norm: float = 0.0


@dataclass(frozen=True)
class Config:
    dataset_type: str = "kitti"        # 'kitti' | 'didi' | 'didi2' | 'test'
    top: TopGrid = field(default_factory=TopGrid)
    front: FrontGrid = field(default_factory=FrontGrid)
    rpn: RpnConfig = field(default_factory=RpnConfig)
    rcnn: RcnnConfig = field(default_factory=RcnnConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    image_width: int = 1242            # KITTI (config.py:149-151)
    image_height: int = 375
    # camera-image crop (didi: sky/hood removal, reference config.py:126-140);
    # rgb_shape and the didi rgb projection account for it
    image_crop_left: int = 0
    image_crop_right: int = 0
    image_crop_top: int = 0
    image_crop_bottom: int = 0
    tracklet_gt_scale: float = 1.6     # cfg.TRACKLET_GTBOX_LENGTH_SCALE

    # -- calibration ---------------------------------------------------------
    @property
    def matrix_mt(self) -> np.ndarray:
        return KITTI_MATRIX_Mt

    @property
    def matrix_kt(self) -> np.ndarray:
        return KITTI_MATRIX_Kt

    @property
    def velo_to_cam(self) -> np.ndarray:
        return KITTI_MATRIX_T_VELO_2_CAM

    @property
    def r_rect(self) -> np.ndarray:
        return KITTI_MATRIX_R_RECT_0

    # -- derived shapes ------------------------------------------------------
    @property
    def top_shape(self) -> Tuple[int, int, int]:
        return self.top.shape

    @property
    def front_shape(self) -> Tuple[int, int, int]:
        return self.front.shape

    @property
    def rgb_shape(self) -> Tuple[int, int, int]:
        # the network consumes the CROPPED camera image (reference crops
        # sky/hood rows on the didi path, config.py:126-140)
        return (self.image_height - self.image_crop_top
                - self.image_crop_bottom,
                self.image_width - self.image_crop_left
                - self.image_crop_right, 3)

    def top_feature_shape(self, stride: Optional[int] = None) -> Tuple[int, int]:
        """Feature-map (H, W) at a given stride (reference mv3d.py:68-69)."""
        stride = stride or self.model.rpn_stride
        return (math.ceil(self.top.shape[0] / stride),
                math.ceil(self.top.shape[1] / stride))

    @property
    def num_anchors(self) -> int:
        h, w = self.top_feature_shape()
        return h * w * len(self.model.bases)


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def kitti_config(**overrides: Any) -> Config:
    return replace(Config(dataset_type="kitti"), **overrides)


def didi_config(**overrides: Any) -> Config:
    """Didi round-1 preset (reference src/config.py:155-165)."""
    top = TopGrid(x_min=-45, x_max=45, y_min=-10, y_max=10,
                  z_min=-3.0, z_max=0.7, x_div=0.2, y_div=0.2, z_div=0.3)
    return replace(Config(dataset_type="didi", top=top,
                          image_width=1368, image_height=1096,
                          image_crop_top=400, image_crop_bottom=100),
                   **overrides)


def didi2_config(**overrides: Any) -> Config:
    """Didi round-2 preset (reference src/config.py:166-176)."""
    top = TopGrid(x_min=-50, x_max=50, y_min=-30, y_max=30,
                  z_min=-3.5, z_max=0.6, x_div=0.2, y_div=0.2, z_div=0.3)
    return replace(Config(dataset_type="didi2", top=top,
                          image_width=1368, image_height=1096,
                          image_crop_top=400, image_crop_bottom=100),
                   **overrides)


_PRESETS = {"kitti": kitti_config, "didi": didi_config, "didi2": didi2_config}


def make_config(dataset_type: str = "kitti", **overrides: Any) -> Config:
    try:
        return _PRESETS[dataset_type](**overrides)
    except KeyError:
        raise ValueError(f"unexpected dataset_type: {dataset_type!r}") from None


# Default module-level config (KITTI), analogous to `from config import cfg`.
cfg = kitti_config()
