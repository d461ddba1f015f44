"""Card milliseconds a frame of AVOD's stage ``img_pyramid``: the image's
VGG pyramid. The compute (kernels and fills, ``trace.COMPUTE_CATS``,
their intervals' union) launched under the range
``mv3d.program.img_pyramid``, over the traced frames
(``harness/stages.py``). None where the program opens no such range."""

from harness import stages


def read(rec):
    return stages.card_ms(rec, "img_pyramid")
