"""Contextualized MLPs (port of
`generative_recommenders_tpu/modules/contextualize_mlps.py`), padded-dense.

* `SimpleContextualizedMLP`: Dense -> SwishLN -> Dense -> LN over the
  sequence; the context is not used.
* `ParameterizedContextualizedMLP`: the contextual embedding generates a
  per-example [Din, Dout] weight matrix (layer-normed over the whole matrix)
  applied to every position, plus a contextual bias: the reference's
  ``jagged_dense_bmm_broadcast_add`` as one batched matmul over the padded
  layout.

The parameter names are the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.modules.mlp import Dense, SwishLayerNorm, SwishMLP, new_param, ones, zeros


class SimpleContextualizedMLP(nn.Module):
    def __init__(
        self, sequential_input_dim: int, sequential_output_dim: int, hidden_dim: int,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.mlp = SwishMLP(sequential_input_dim, hidden_dim, sequential_output_dim, gen)

    def forward(
        self,
        seq_embeddings: torch.Tensor,  # [B, N, Din]
        contextual_embeddings: Optional[torch.Tensor] = None,  # unused
    ) -> torch.Tensor:
        return self.mlp(seq_embeddings)


class ParameterizedContextualizedMLP(nn.Module):
    def __init__(
        self,
        contextual_embedding_dim: int,
        sequential_input_dim: int,
        sequential_output_dim: int,
        hidden_dim: int,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.sequential_input_dim = sequential_input_dim
        self.sequential_output_dim = sequential_output_dim
        self.dense_features_compress = Dense(contextual_embedding_dim, hidden_dim, gen)
        self.attn_raw_weights = Dense(hidden_dim, sequential_input_dim * sequential_output_dim, gen)
        wshape = (sequential_input_dim, sequential_output_dim)
        self.attn_w_norm_weight = new_param(wshape, ones, gen)
        self.attn_w_norm_bias = new_param(wshape, zeros, gen)
        self.res_fc1 = Dense(hidden_dim, hidden_dim, gen)
        self.res_sln = SwishLayerNorm(hidden_dim)
        self.res_fc2 = Dense(hidden_dim, sequential_output_dim, gen)

    def forward(
        self,
        seq_embeddings: torch.Tensor,  # [B, N, Din]
        contextual_embeddings: torch.Tensor,  # [B, Dc]
    ) -> torch.Tensor:
        shared = self.dense_features_compress(contextual_embeddings)  # [B, H]
        raw_w = self.attn_raw_weights(shared).reshape(-1, self.sequential_input_dim, self.sequential_output_dim)
        mean = raw_w.mean(dim=(1, 2), keepdim=True)
        var = (raw_w - mean).square().mean(dim=(1, 2), keepdim=True)
        w = (raw_w - mean) * torch.rsqrt(var + 1e-5) * self.attn_w_norm_weight + self.attn_w_norm_bias
        bias = self.res_fc2(self.res_sln(self.res_fc1(shared)))  # [B, Dout]
        dtype = seq_embeddings.dtype
        out = torch.einsum("bnd,bde->bne", seq_embeddings.float(), w.to(dtype).float()).to(dtype)
        return out + bias[:, None, :].to(dtype)
