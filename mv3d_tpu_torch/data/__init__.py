"""Host-side data: KITTI readers, tracklets, crop + pad, host aux planes,
the rgb resize and the batch loader."""
