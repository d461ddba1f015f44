"""The ``mv3d`` family's program: the port's MV3D, frozen by
``export_serving`` at the cell's batch size and loaded as a serving host
loads it (``load_serving``)."""

from __future__ import annotations

import gc
import os
from typing import Any, Callable, Dict

import torch

from mv3d_tpu_torch.serving.export import (config_from_dict, export_serving,
                                           load_serving)
from mv3d_tpu_torch.train.trainer import MV3D


def served(tree: Dict[str, Any], state: Dict[str, torch.Tensor],
           batch_size: int, score_threshold: float, device, work: str,
           mark: Callable[[str], None]) -> Callable:
    """The served ``predict_batch`` of the program at configuration
    ``tree`` with weights ``state``: raw (points, rgb) frames in, per
    frame (boxes3d, probs) out. ``work`` holds the artifact; ``mark(name)``
    closes the set-up phases ``model``, ``export`` and ``load``."""
    model = MV3D(config_from_dict(tree), device=device, checkpoint_dir=work,
                 log_dir=work)
    model.model.load_state_dict(state)
    mark("model")
    artifact = os.path.join(work, "artifact")
    export_serving(model, artifact, batch_size=batch_size,
                   score_threshold=score_threshold)
    del model
    gc.collect()
    mark("export")
    predict = load_serving(artifact, device=device).predict_batch
    mark("load")
    return predict
