"""Card milliseconds a frame of the program's stage ``roi_fusion``: the
projections of the proposals, ROI align over each view and the fusion
head. The compute (kernels and fills, ``trace.COMPUTE_CATS``, their
intervals' union) launched under the range ``mv3d.program.roi_fusion``,
over the traced frames (``harness/stages.py``). None where the program
opens no such range."""

from harness import stages


def read(rec):
    return stages.card_ms(rec, "roi_fusion")
