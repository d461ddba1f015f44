"""Sequence-model motion tracker (a GRU over box trajectories).

Port of ``mv3d_tpu/tracking/seq_model.py``: a small recurrent model over
per-frame box translations that predicts the next-frame position, a
learned alternative to the UKF for tracklet smoothing and prediction.

flax's ``nn.RNN(nn.GRUCell)`` becomes ``nn.GRU`` (one layer, batch first,
zero initial carry). The gates are the same functions: torch's ``b_hr``
and ``b_hz`` stand where flax's ``hr``/``hz`` have no bias, so they start
at 0 (also in a GRU converted from flax,
:func:`mv3d_tpu_torch.convert.motion_gru_state_dict`) and a gradient hook
keeps them there. The torch module therefore counts ``2 * hidden``
parameters more than the flax one. The random init follows flax's scheme
(lecun-normal input and output kernels, orthogonal recurrent kernels per
gate, zero biases) from a ``torch.Generator``; its values are not JAX's.
``optax.adam`` becomes ``torch.optim.Adam`` (the same update).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator):
    """flax's ``lecun_normal``: a normal truncated at 2 std, scaled to
    variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)


class MotionGRU(nn.Module):
    """GRU over (dx, dy, dz) displacement sequences -> next displacement."""

    def __init__(self, hidden: int = 64):
        super().__init__()
        self.hidden = hidden
        self.gru = nn.GRU(3, hidden, batch_first=True)
        self.dense = nn.Linear(hidden, 3)
        # flax's hr/hz have no bias: b_hr and b_hz get no gradient, so they
        # stay where they start (0), and the model trains as flax's does
        self.gru.bias_hh_l0.register_hook(self._hn_bias_grad_only)

    def _hn_bias_grad_only(self, grad: torch.Tensor) -> torch.Tensor:
        keep = torch.zeros_like(grad)
        keep[2 * self.hidden:] = grad[2 * self.hidden:]
        return keep

    def init_weights(self, generator: torch.Generator) -> None:
        h = self.hidden
        with torch.no_grad():
            for gate in range(3):          # r, z, n: flax's ir/hr, iz/hz, in/hn
                rows = slice(gate * h, (gate + 1) * h)
                _lecun_normal_(self.gru.weight_ih_l0[rows], 3, generator)
                nn.init.orthogonal_(self.gru.weight_hh_l0[rows],
                                    generator=generator)
            self.gru.bias_ih_l0.zero_()
            self.gru.bias_hh_l0.zero_()
            _lecun_normal_(self.dense.weight, h, generator)
            self.dense.bias.zero_()

    def forward(self, deltas: torch.Tensor) -> torch.Tensor:
        """(B, T, 3) past displacements -> (B, T, 3) predicted next ones."""
        hs, _ = self.gru(deltas)
        return self.dense(hs)


class SeqMotionTracker:
    """Train/predict wrapper: learns object motion from trajectories and
    predicts the next position (teacher-forced next-step objective). Runs
    on ``device``, the card by default."""

    def __init__(self, hidden: int = 64, lr: float = 1e-2, seed: int = 0,
                 device=None):
        from ..train.trainer import resolve_device

        self.device = resolve_device(device)
        self.model = MotionGRU(hidden=hidden)
        self.model.init_weights(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=lr)

    @staticmethod
    def _to_deltas(tracks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(B, T, 3) positions -> (inputs (B, T-2, 3), targets (B, T-2, 3))."""
        d = np.diff(tracks, axis=1)
        return d[:, :-1], d[:, 1:]

    def fit(self, tracks: np.ndarray, steps: int = 200) -> float:
        """Train on (B, T, 3) position trajectories; returns the last
        step's loss (before its update)."""
        din, dtg = (torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                    for x in self._to_deltas(np.asarray(tracks, np.float32)))
        loss = None
        for _ in range(steps):
            self.opt.zero_grad(set_to_none=True)
            loss = torch.mean((self.model(din) - dtg) ** 2)
            loss.backward()
            self.opt.step()
        return float(loss.detach())

    @torch.no_grad()
    def predict_next(self, history: np.ndarray) -> np.ndarray:
        """(B, T, 3) past positions -> (B, 3) predicted next positions."""
        history = np.asarray(history, np.float32)
        d = torch.from_numpy(np.diff(history, axis=1)).to(self.device)
        pred = self.model(d)[:, -1].cpu().numpy()
        return history[:, -1] + pred
