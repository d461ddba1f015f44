"""The port's entry points run in full f32: each turns off cuDNN's and
cuBLAS's TF32 (``torch.backends.cudnn.allow_tf32``,
``torch.backends.cuda.matmul.allow_tf32``) where it picks its device
(``train.trainer.resolve_device``), so the program the card checks hold
against the CPU is the program ``MV3D``, ``Trainer``, serving and the
commands run. The commands (``cli.train``, ``cli.test``,
``cli.rehearsal``, ``cli.preprocess``, ``cli.tracking``, ``cli.export``,
``cli.serve``) reach it through ``resolve_device`` or the constructors
below.

Each case turns both switches on (``monkeypatch`` restores them), builds
the entry point on the CPU and finds both off. ``chip_smoke.py`` checks
the same on the card, in a fresh process that sets nothing itself.

Wall time about 7 s on the CPU.
"""

import pytest
import torch

from __graft_entry__ import _tiny_config
from mv3d_tpu_torch.train.trainer import MV3D, Trainer, resolve_device

from test_torch_config import to_port_config

torch.set_num_threads(2)

PCFG = to_port_config(_tiny_config())


def _mv3d(tmp):
    return lambda: MV3D(PCFG, device="cpu")


def _trainer(tmp):
    return lambda: Trainer(None, cfg=PCFG, device="cpu",
                           checkpoint_dir=str(tmp / "ck"),
                           log_dir=str(tmp / "log"))


def _load_serving(tmp):
    from mv3d_tpu_torch.serving.export import export_serving, load_serving
    art = export_serving(MV3D(PCFG, device="cpu").get_variables(), PCFG,
                         str(tmp / "art"))
    return lambda: load_serving(art, device="cpu")


def _preprocessor(tmp):
    from mv3d_tpu_torch.data.preprocess import Preprocessor
    return lambda: Preprocessor(str(tmp / "dump"), PCFG, device="cpu")


def _process_group(tmp):
    from mv3d_tpu_torch.parallel import mesh as pm

    def join_and_leave():
        pm.init_process_group("cpu", 0, 1, f"file://{tmp / 'store'}")
        torch.distributed.destroy_process_group()

    return join_and_leave


def _seq_tracker(tmp):
    from mv3d_tpu_torch.tracking.seq_model import SeqMotionTracker
    return lambda: SeqMotionTracker(hidden=4, device="cpu")


def _resolve_device(tmp):
    return lambda: resolve_device("cpu")


ENTRY_POINTS = {"MV3D": _mv3d, "Trainer": _trainer,
                "load_serving": _load_serving, "Preprocessor": _preprocessor,
                "init_process_group": _process_group,
                "SeqMotionTracker": _seq_tracker,
                "resolve_device": _resolve_device}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_turns_tf32_off(entry, tmp_path, monkeypatch):
    build = ENTRY_POINTS[entry](tmp_path)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    build()
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_asking_for_the_card_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MV3D(PCFG, device="cuda")
