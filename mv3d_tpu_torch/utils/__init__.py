"""Host utilities: PNG I/O, debug drawing, logging, timing, metrics and
debug images, the dashboard and data checks."""
