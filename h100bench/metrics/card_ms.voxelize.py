"""Card milliseconds a frame of the program's stage ``voxelize``: the
voxelizer: the lane-padded sweep (K2, ``mv3d::voxelize_padded``, found
by its kernels' names where the trace ties them to no launch) and the
casts and fills around it. The compute (kernels and fills,
``trace.COMPUTE_CATS``, their intervals' union) launched under the range
``mv3d.program.voxelize``, over the traced frames
(``harness/stages.py``). None where the program opens no such range."""

from harness import stages


def read(rec):
    return stages.card_ms(rec, "voxelize")
