"""The frozen int8 serving program (``model.quant="int8"``, hwc) against
the port's eager call and the JAX package's exported int8 artifact, with
tests/test_torch_frozen.py's helpers and tolerances; and the int8 weight
cache of ``models/backbone.py`` under ``torch.export``.

The program holds the int8 weights that the eager cache kept (brought up
to date just before the trace) as constants, and quantizes only the
activations at each call. Against JAX, the program is
traced while JAX's int8 activations are replayed (each then a constant
of the program, in order), as tests/test_torch_quantized.py replays
them. Wall time about 2 min on the CPU (an int8 trace takes ~25 s here).
"""

import numpy as np
import torch

from mv3d_tpu_torch.models import backbone

from test_torch_frozen import (_targets, built,  # noqa: F401
                               check_bn_relu_sites, check_equals_eager,
                               check_graph, check_lean, check_matches_jax,
                               jax_variables)

torch.set_num_threads(2)


def test_graph_holds_the_operators(built):  # noqa: F811
    check_graph(built, "int8")


def test_graph_holds_one_bn_relu_per_batchnorm_site(  # noqa: F811
        built, monkeypatch):
    check_bn_relu_sites(built, "int8", monkeypatch)


def test_graph_is_lean(built):  # noqa: F811
    check_lean(built, "int8")


def test_frozen_equals_eager(built):  # noqa: F811
    check_equals_eager(built, "int8")


def test_frozen_matches_jax_artifact(built, monkeypatch,  # noqa: F811
                                     tmp_path):
    check_matches_jax(built, "int8", monkeypatch, tmp_path)


def test_int8_weight_cache_exports():
    """An int8 conv in eval mode exports. With no kept weight the program
    quantizes the weight at each call; after ``keep_quantized`` the kept
    int8 weight is a constant of the program, which then quantizes the
    activation alone. Both equal the eager layer bit for bit; eager
    calls keep their cache, the same int8 weight after the export."""
    conv = backbone.Conv2d(3, 8, 3, padding=1, bias=False)
    conv.quant = "int8"
    conv.eval()
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 9, 9)
                         .astype(np.float32))
    program = torch.export.export(conv, (x,), strict=False)
    assert conv._qweight is None
    targets = _targets(program.graph)
    assert "aten._int_mm.default" in targets
    assert targets.count("aten.amax.default") == 2    # weight, activation
    want = conv(x)
    kept = conv._qweight
    assert kept is not None
    torch.testing.assert_close(program.module()(x), want, rtol=0, atol=0)
    backbone.keep_quantized(conv)
    assert conv._qweight is kept
    frozen = torch.export.export(conv, (x,), strict=False)
    assert _targets(frozen.graph).count("aten.amax.default") == 1
    assert [t.dtype for t in frozen.constants.values()
            if t.dtype == torch.int8] == [torch.int8]
    torch.testing.assert_close(frozen.module()(x), want, rtol=0, atol=0)
    torch.testing.assert_close(conv(x), want, rtol=0, atol=0)
    after = conv._qweight
    conv(x)
    assert conv._qweight is after
    for got, was in zip(after[2], kept[2]):
        assert torch.equal(got, was)
