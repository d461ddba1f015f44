"""Host-side data: crop + pad, host aux planes, the batch loader."""
