"""Host-side data: KITTI readers, tracklets, crop + pad, host aux planes,
the rgb resize, the batch loader, the offline preprocessor and its
precomputed-view dataset."""
