"""The DLRM trainer's sparse/dense optimizer split (port of
`generative_recommenders_tpu/parallel/optimizers.py`, with the table rule of
`parallel/sharding.py:is_table_path` in `param_labels`), on one device.

Embedding-table parameters get row-wise Adagrad (torchrec's RowWiseAdagrad
rule, written out here); everything else gets Adam. The JAX package labels
them with `optax.multi_transform`; here they are two optimizers over two
parameter lists, stepped one after the other.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

# name fragments that mark a table (`parallel/sharding.py:_TABLE_PATH_KEYS`)
_TABLE_PATH_KEYS = ("embedding_module", "embedding_tables", "item_embedding")


def param_labels(model: nn.Module) -> Dict[str, str]:
    """"sparse" or "dense" for each named parameter: a 2-D parameter whose
    name holds one of the table fragments is sparse. The rule is copied as
    it is, quirk included: "item_embedding" also matches the 2-D kernels of
    DlrmHSTU's ``item_embedding_mlp``, which therefore train under row-wise
    Adagrad at the sparse learning rate, as in the JAX package."""
    return {
        name: "sparse" if (any(k in name for k in _TABLE_PATH_KEYS) and p.dim() == 2) else "dense"
        for name, p in model.named_parameters()
    }


class RowWiseAdagrad(torch.optim.Optimizer):
    """torchrec's row-wise Adagrad: for a 2-D parameter one accumulator per
    row, ``acc += mean(g^2, dim=1)`` and ``p -= lr / (sqrt(acc) + eps) * g``;
    for any other parameter the elementwise form ``acc += g^2``."""

    def __init__(self, params, lr: float = 0.01, eps: float = 1e-8) -> None:
        super().__init__(params, dict(lr=lr, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, eps = group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    shape = p.shape[:1] if p.dim() == 2 else p.shape
                    state["acc"] = torch.zeros(shape, dtype=torch.float32, device=p.device)
                acc = state["acc"]
                if p.dim() == 2:
                    acc.add_(g.square().mean(dim=1))
                    p.sub_((lr / (acc.sqrt() + eps))[:, None] * g)
                else:
                    acc.add_(g * g)
                    p.sub_(lr / (acc.sqrt() + eps) * g)
        return loss


def make_dlrm_optimizer(
    model: nn.Module, dense_lr: float = 1e-3, sparse_lr: float = 0.01
) -> Tuple[RowWiseAdagrad, torch.optim.Adam]:
    """(row-wise Adagrad over the sparse parameters, Adam over the rest).
    `torch.optim.Adam`'s defaults (betas 0.9 / 0.999, eps 1e-8) are
    `optax.adam`'s."""
    labels = param_labels(model)
    groups = {"sparse": [], "dense": []}
    for name, p in model.named_parameters():
        groups[labels[name]].append(p)
    return RowWiseAdagrad(groups["sparse"], lr=sparse_lr), torch.optim.Adam(groups["dense"], lr=dense_lr)
