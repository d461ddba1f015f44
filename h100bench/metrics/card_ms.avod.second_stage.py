"""Card milliseconds a frame of AVOD's stage ``second_stage``: the second
stage: the 7 x 7 crops of each proposal in both views and the three FC
layers and heads. The compute (kernels and fills,
``trace.COMPUTE_CATS``, their intervals' union) launched under the range
``mv3d.program.second_stage``, over the traced frames
(``harness/stages.py``). None where the program opens no such range."""

from harness import stages


def read(rec):
    return stages.card_ms(rec, "second_stage")
