"""The copy's compute ops: the voxelizer over the plain kernels of
:mod:`.plain`, anchors, boxes, NMS, proposals, ROI-align, detection
decode, the int8 products."""
