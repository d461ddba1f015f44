"""Inference API (MV3D)."""
