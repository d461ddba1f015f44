"""Card milliseconds a frame of AVOD's stage ``detect``: the detections:
the box_4c decode, the box fit and orientation, and the final NMS
(``mv3d::nms_topk``) and threshold. The compute (kernels and fills,
``trace.COMPUTE_CATS``, their intervals' union) launched under the range
``mv3d.program.detect``, over the traced frames (``harness/stages.py``).
None where the program opens no such range."""

from harness import stages


def read(rec):
    return stages.card_ms(rec, "detect")
