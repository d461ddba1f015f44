"""Card milliseconds a frame of the program's stage ``detect``: the final
NMS over the fused detections (``rcnn_nms``). The compute (kernels and
fills, ``trace.COMPUTE_CATS``, their intervals' union) launched under
the range ``mv3d.program.detect``, over the traced frames
(``harness/stages.py``). None where the program opens no such range."""

from harness import stages


def read(rec):
    return stages.card_ms(rec, "detect")
