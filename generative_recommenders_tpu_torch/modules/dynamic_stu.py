"""Dynamic STU wrappers: stochastic depth and last-window (L2) execution
(port of `generative_recommenders_tpu/modules/dynamic_stu.py`).

* `SDSTU` skips the wrapped layer in training with probability
  ``dropout_ratio``: one draw per call from its own generator (the JAX
  package's ``"stochastic_depth"`` stream), not the dropout's. The JAX
  module runs the layer and then selects ``where(skip, x, out)``; here a
  skipped layer is not run at all (no kernel launches). Its parameters then
  get no gradient, which the trainer turns into zeros
  (`train/dlrm_train.py`), so that Adam's moments decay on that step as
  optax's do on the JAX package's zero gradient.
* `L2STU` runs the wrapped layer only on each row's newest ``max_l2_len``
  tokens and passes the rest through. The contextual prefix never enters
  the window: the window of row b is [max(len_b - w, C), len_b) with w =
  min(max_l2_len, N), and the inner layer runs with contextual_seq_len 0
  (`STUStack` builds it so) and the outer layer's silu normaliser.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class SDSTU(nn.Module):
    """Stochastic-depth wrapper."""

    def __init__(self, stu: nn.Module, dropout_ratio: float = 0.5) -> None:
        super().__init__()
        self.stu = stu
        self.dropout_ratio = dropout_ratio

    def skip(self, sd_gen: Optional[torch.Generator]) -> bool:
        """The training step's coin: uniform [0, 1) <= dropout_ratio, drawn
        from ``sd_gen`` (a CPU generator keeps the coin on the host)."""
        if sd_gen is None:
            raise ValueError("stochastic depth needs a torch.Generator for its coin")
        return bool(torch.rand((), generator=sd_gen, device=sd_gen.device).item() <= self.dropout_ratio)

    def forward(
        self,
        x: torch.Tensor,
        lengths: torch.Tensor,
        num_targets: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        gen: Optional[torch.Generator] = None,
        sd_gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if not deterministic and self.dropout_ratio > 0.0 and self.skip(sd_gen):
            return x
        return self.stu(x, lengths, num_targets, deterministic, gen, sd_gen)


class L2STU(nn.Module):
    """Last-window wrapper: the window of each row is gathered from a copy of
    x padded by w rows (so every index is distinct and in range), run through
    the wrapped layer with the window's lengths, and scattered back."""

    def __init__(self, stu: nn.Module, max_l2_len: int, contextual_seq_len: int = 0) -> None:
        super().__init__()
        self.stu = stu
        self.max_l2_len = max_l2_len
        self.contextual_seq_len = contextual_seq_len

    def forward(
        self,
        x: torch.Tensor,  # [B, N, D]
        lengths: torch.Tensor,  # int[B]
        num_targets: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        gen: Optional[torch.Generator] = None,
        sd_gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        B, N, _ = x.shape
        C = self.contextual_seq_len
        w = min(self.max_l2_len, N)
        l2_lengths = (lengths - C).clamp(0, w)
        start = (lengths - w).clamp_min(C).long()
        rows = torch.arange(B, device=x.device)[:, None]
        cols = start[:, None] + torch.arange(w, device=x.device)[None, :]
        xp = F.pad(x, (0, 0, 0, w))
        valid = (torch.arange(w, device=x.device)[None, :] < l2_lengths[:, None])[:, :, None]
        before = xp[rows, cols]
        window = before * valid.to(x.dtype)
        out = self.stu(window, l2_lengths, num_targets, deterministic, gen, sd_gen)
        return xp.index_put((rows, cols), torch.where(valid, out, before))[:, :N]

