"""The ``avod`` family's program: the port's AVOD (``model.arch ==
"avod"``), frozen by ``export_serving`` at the cell's batch size and loaded
as a serving host loads it (``load_serving``). A port without AVOD fails
at the import, before any work."""

from __future__ import annotations

from mv3d_tpu_torch.models.avod_net import AVODNet  # noqa: F401

from .mv3d import served  # noqa: F401  (the same entry points)
