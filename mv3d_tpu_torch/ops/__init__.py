"""Compute ops of the port: voxelizer + sweep kernel, anchors, boxes, NMS,
proposals, ROI-align, detection decode."""
