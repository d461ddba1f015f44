"""Tee-style text logger: stdout and a log file.

Port of ``mv3d_tpu/utils/logger.py``."""

from __future__ import annotations

import os
import sys
from typing import Optional


class Logger:
    """Writes to stdout and, if given, appends to a log file."""

    def __init__(self, path: Optional[str] = None, mode: str = "a"):
        self.file = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.file = open(path, mode)

    def write(self, message: str):
        sys.stdout.write(message)
        sys.stdout.flush()
        if self.file is not None:
            self.file.write(message)
            self.file.flush()

    def close(self):
        if self.file is not None:
            self.file.close()
            self.file = None
