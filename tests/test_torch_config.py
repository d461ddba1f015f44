"""The port's config copy against the JAX package's config, and the
converter the parity tests use: a JAX ``Config`` becomes the port's
``Config`` field by field, so both packages run from one set of
overrides. Comparisons are exact (frozen dataclass equality)."""

import dataclasses

import numpy as np
import pytest

from mv3d_tpu import config as jconfig
from mv3d_tpu_torch import config as tconfig

from __graft_entry__ import _tiny_config


def to_port_config(cfg):
    """A JAX ``Config`` (or any of its nested dataclasses) as the port's
    dataclass of the same name, converted field by field."""
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{f.name: (to_port_config(v)
                           if dataclasses.is_dataclass(v) else v)
                  for f in dataclasses.fields(cfg)
                  for v in [getattr(cfg, f.name)]})


_CLASSES = ["TopGrid", "FrontGrid", "RpnConfig", "RcnnConfig",
            "ModelConfig", "PipelineConfig", "TrainConfig", "Config"]


@pytest.mark.parametrize("name", _CLASSES)
def test_dataclass_fields_and_defaults_match(name):
    jf = dataclasses.fields(getattr(jconfig, name))
    tf = dataclasses.fields(getattr(tconfig, name))
    assert [f.name for f in jf] == [f.name for f in tf]
    assert to_port_config(getattr(jconfig, name)()) \
        == getattr(tconfig, name)()


@pytest.mark.parametrize("preset", ["kitti", "didi", "didi2"])
def test_presets_convert_to_the_port_presets(preset):
    jc, tc = jconfig.make_config(preset), tconfig.make_config(preset)
    assert to_port_config(jc) == tc
    assert (tc.top_shape, tc.front_shape, tc.rgb_shape, tc.num_anchors) \
        == (jc.top_shape, jc.front_shape, jc.rgb_shape, jc.num_anchors)
    np.testing.assert_array_equal(tc.matrix_mt, jc.matrix_mt)
    np.testing.assert_array_equal(tc.matrix_kt, jc.matrix_kt)


def test_overrides_build_the_same_config():
    kv = ["rpn.nms_thresh", "0.3", "train.lr_schedule", "cosine",
          "model.compute_dtype", "float32", "pipeline.max_points", "4096"]
    jc = jconfig.config_from_list(jconfig.kitti_config(), kv)
    tc = tconfig.config_from_list(tconfig.kitti_config(), kv)
    assert to_port_config(jc) == tc
    assert to_port_config(_tiny_config()).top_shape == (80, 60, 27)
