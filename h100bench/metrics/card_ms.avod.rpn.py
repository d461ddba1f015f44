"""Card milliseconds a frame of AVOD's stage ``rpn``: the RPN: the
bottlenecks, the empty-anchor filter, the 3 x 3 crops of every anchor in
both views, the fc heads and the offsets' decode. The compute (kernels
and fills, ``trace.COMPUTE_CATS``, their intervals' union) launched
under the range ``mv3d.program.rpn``, over the traced frames
(``harness/stages.py``). None where the program opens no such range."""

from harness import stages


def read(rec):
    return stages.card_ms(rec, "rpn")
