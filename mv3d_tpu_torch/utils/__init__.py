"""Host utilities: PNG I/O, debug drawing, logging, timing, metrics and
debug images, the dashboard, data checks, the cost model (``macs``) and
profiling helpers (``profiling``)."""
