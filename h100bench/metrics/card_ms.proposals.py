"""Card milliseconds a frame of the program's stage ``proposals``: the
anchor mask, the proposal layer (decode, cut, NMS) and the proposals'
lift to 3D. The compute (kernels and fills, ``trace.COMPUTE_CATS``,
their intervals' union) launched under the range
``mv3d.program.proposals``, over the traced frames
(``harness/stages.py``). None where the program opens no such range."""

from harness import stages


def read(rec):
    return stages.card_ms(rec, "proposals")
