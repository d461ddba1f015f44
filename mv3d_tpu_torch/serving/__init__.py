"""Deployment surface: serving artifacts (weights, signature, config) and
their numpy-in, numpy-out runtime."""

from .export import (ServingModel, build_serving_fn, export_serving,
                     load_serving)

__all__ = ["ServingModel", "build_serving_fn", "export_serving",
           "load_serving"]
