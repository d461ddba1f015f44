"""Card milliseconds a frame of the program's stage ``top_trunk``: the top
view's trunk and RPN head (``top_rpn``). The compute (kernels and fills,
``trace.COMPUTE_CATS``, their intervals' union) launched under the range
``mv3d.program.top_trunk``, over the traced frames
(``harness/stages.py``). None where the program opens no such range."""

from harness import stages


def read(rec):
    return stages.card_ms(rec, "top_trunk")
