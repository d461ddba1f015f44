"""Host utilities: PNG I/O, logging, timing, metrics, the dashboard and
data checks."""
