"""Compute ops of the port: voxelizer and its two kernels (fused sweep,
heights scatter-max), anchors, boxes, NMS, proposals, ROI-align, detection
decode."""
