"""Compute ops of the port: voxelizer and its four kernels (fused sweep,
lane-padded sweep, heights scatter-max, bitonic sort), the quantized point
transfer, the int8 products, anchors, boxes, NMS, proposals, ROI-align,
detection decode."""
