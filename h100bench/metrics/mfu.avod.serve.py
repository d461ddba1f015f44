"""Model FLOP utilization of AVOD's serving, in %: ``mfu.serve``'s formula
(``metrics/mfu.serve.py``): the reference's FLOPs per frame
(``FlopCounterMode`` over AVOD's plain reference at the cell's shapes,
whose RPN heads run on the non-empty anchors only, as AVOD's do) times
the traced frames, over the seconds the card's SMs were busy with them,
over the card's bf16 dense peak."""

from harness import spec


def read(rec):
    return spec.load_reader("mfu.serve").read(rec)
