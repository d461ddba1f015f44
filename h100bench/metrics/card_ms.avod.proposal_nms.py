"""Card milliseconds a frame of AVOD's stage ``proposal_nms``: the proposal
NMS: the objectness sort and the NMS kernel (``mv3d::nms_topk``) down to
the kept proposals. The compute (kernels and fills,
``trace.COMPUTE_CATS``, their intervals' union) launched under the range
``mv3d.program.proposal_nms``, over the traced frames
(``harness/stages.py``). None where the program opens no such range."""

from harness import stages


def read(rec):
    return stages.card_ms(rec, "proposal_nms")
