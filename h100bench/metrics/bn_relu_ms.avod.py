"""Card milliseconds a frame of AVOD's eval-mode BatchNorm + ReLU passes
(``mv3d::bn_relu``, every conv and transposed conv of both pyramids and
the RPN's bottlenecks): ``bn_relu_ms``'s reading
(``metrics/bn_relu_ms.py``) in the AVOD cell."""

from harness import spec


def read(rec):
    return spec.load_reader("bn_relu_ms").read(rec)
