"""Staged-training recipes.

Port of ``mv3d_tpu/experiments/task.py``: the published two-stage MV3D
schedule (the RPN alone, then the image, front and fusion subnets on the
trained RPN) over a ``Trainer`` factory, each stage run by
:func:`run_task`, which retries a stage that fails or finishes
suspiciously fast, as the JAX package does.
"""

from __future__ import annotations

import time
from typing import Callable

from ..models.nets import (FRONT_FEATURE, FUSION, IMAGE_FEATURE,
                           SUBNET_NAMES, TOP_VIEW_RPN)


def run_task(fn: Callable[[], object], retries: int = 3,
             min_seconds: float = 10.0, log=print):
    """Run ``fn`` up to ``retries`` times: again after an exception (each
    failed attempt is logged) or when it returns in under ``min_seconds``
    (the last attempt's result is kept however fast). Raises
    ``RuntimeError`` from the last exception when every attempt failed."""
    error = None
    for attempt in range(retries):
        t0 = time.time()
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — retry wrapper by design
            log(f"task attempt {attempt + 1} failed: {e}")
            error = e
            continue
        if time.time() - t0 >= min_seconds or attempt == retries - 1:
            return out
        log(f"task attempt {attempt + 1} finished suspiciously fast; "
            f"retrying")
    raise RuntimeError(f"task failed after {retries} attempts") from error


class Task:
    """The staged-training recipes over a Trainer factory:
    ``trainer_factory(train_targets, continue_train, pretrained)`` returns
    a ``Trainer``."""

    def __init__(self, trainer_factory, fast_test: bool = False):
        self.factory = trainer_factory
        self.iters = 1 if fast_test else 10000

    def train_rpn(self, rounds: int = 1):
        """Stage 1: the RPN alone (further rounds continue it)."""
        tr = self.factory([TOP_VIEW_RPN], continue_train=False, pretrained=[])
        run_task(lambda: tr(max_iter=self.iters))
        for _ in range(rounds - 1):
            tr = self.factory([TOP_VIEW_RPN], continue_train=True,
                              pretrained=[])
            run_task(lambda: tr(max_iter=self.iters))
        return tr

    def train_img_and_fusion(self, rounds: int = 1):
        """Stage 2: the image, front and fusion subnets on a pretrained
        RPN."""
        targets = [IMAGE_FEATURE, FRONT_FEATURE, FUSION]
        tr = self.factory(targets, continue_train=False,
                          pretrained=[TOP_VIEW_RPN])
        run_task(lambda: tr(max_iter=self.iters))
        for _ in range(rounds - 1):
            tr = self.factory(targets, continue_train=True,
                              pretrained=[TOP_VIEW_RPN])
            run_task(lambda: tr(max_iter=self.iters))
        return tr

    def train_all(self):
        """End-to-end fine-tune of every subnet (the full-net loss mix)."""
        tr = self.factory(list(SUBNET_NAMES), continue_train=True,
                          pretrained=list(SUBNET_NAMES))
        run_task(lambda: tr(max_iter=self.iters))
        return tr
