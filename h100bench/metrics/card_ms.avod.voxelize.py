"""Card milliseconds a frame of AVOD's stage ``voxelize``: AVOD's
voxelizer: the fused sweep (K1, ``mv3d::voxelize_sweep``, found by its
kernels' names where the trace ties them to no launch), the density and
the BEV's assembly. The compute (kernels and fills,
``trace.COMPUTE_CATS``, their intervals' union) launched under the range
``mv3d.program.voxelize``, over the traced frames
(``harness/stages.py``). None where the program opens no such range."""

from harness import stages


def read(rec):
    return stages.card_ms(rec, "voxelize")
