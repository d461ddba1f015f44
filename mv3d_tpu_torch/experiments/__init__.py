"""Experiment orchestration: the staged-training recipes (``Task``)."""

from .task import Task, run_task  # noqa: F401
