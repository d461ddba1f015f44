"""Command-line entry points of the port: ``export`` (a serving artifact)
and ``serve`` (HTTP over one)."""
