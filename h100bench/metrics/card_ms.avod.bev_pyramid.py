"""Card milliseconds a frame of AVOD's stage ``bev_pyramid``: the BEV's VGG
pyramid (encoder, transposed convs, fusions, each with its BatchNorm +
ReLU) and its padding and cut. The compute (kernels and fills,
``trace.COMPUTE_CATS``, their intervals' union) launched under the range
``mv3d.program.bev_pyramid``, over the traced frames
(``harness/stages.py``). None where the program opens no such range."""

from harness import stages


def read(rec):
    return stages.card_ms(rec, "bev_pyramid")
