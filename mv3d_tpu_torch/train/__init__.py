"""Training and inference: targets, losses, augmentation, checkpoints, and
the MV3D / Trainer API."""
