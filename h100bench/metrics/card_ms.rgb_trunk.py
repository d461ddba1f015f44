"""Card milliseconds a frame of the program's stage ``rgb_trunk``: the
camera image's trunk (``rgb_net``). The compute (kernels and fills,
``trace.COMPUTE_CATS``, their intervals' union) launched under the range
``mv3d.program.rgb_trunk``, over the traced frames
(``harness/stages.py``). None where the program opens no such range."""

from harness import stages


def read(rec):
    return stages.card_ms(rec, "rgb_trunk")
