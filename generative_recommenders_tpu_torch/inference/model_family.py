"""Serving model family: quantized sparse stage + dense stage (port of
`generative_recommenders_tpu/inference/model_family.py`).

* sparse: per-row absmax int8 tables with float32 scales, dequantized at
  lookup, then the uih/candidate merge;
* dense: `DlrmHSTU.main_forward`;
* `predict_mfalcon`: prefill once, then score candidate chunks of
  ``max_num_candidates_inference`` against the KV caches. As in the JAX
  package, this path looks up the model's own float tables.

With a serving ``mesh`` (`parallel/mesh.py`) every rank holds the whole
model and its int8 tables, takes its rows of each request batch
(`shard_inputs`: rank k's rows ``[k b, (k + 1) b)``, the JAX package's
batch sharding over every mesh axis), and `predict` / `predict_mfalcon`
return the whole batch's predictions, every rank's gathered in rank order.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from generative_recommenders_tpu_torch.modules.dlrm_hstu import (
    DlrmHSTU,
    lookup_and_merge_features,
)
from generative_recommenders_tpu_torch.parallel.distributed import all_gather_tensor
from generative_recommenders_tpu_torch.parallel.mesh import Mesh
from generative_recommenders_tpu_torch.parallel.sharding import rank_rows
from generative_recommenders_tpu_torch.utils.profiling import span

Table = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def quantize_table(table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise absmax int8 quantization: (int8 rows, float32 scale [R, 1])."""
    scale = table.abs().amax(dim=1, keepdim=True).clamp_min(1e-8)
    q = torch.round(table / scale * 127.0).clamp(-127, 127).to(torch.int8)
    return q, (scale / 127.0).to(torch.float32)


class HSTUModelFamily:
    """A DlrmHSTU bound for serving, on the device its parameters are on."""

    def __init__(self, model: DlrmHSTU, quantize: bool = True, mesh: Optional[Mesh] = None) -> None:
        self.model = model.eval()
        self.mesh = mesh
        self.cfg = model.cfg
        self._quantized = quantize
        self._tables: Dict[str, Table] = {}
        with torch.no_grad():
            for t in model.embedding_tables:
                w = model.table(t.name)
                self._tables[t.name] = quantize_table(w) if quantize else w.detach()

    def shard_inputs(self, tree: Any) -> Any:
        """This rank's rows of every tensor of a request batch (a nested
        dict / tuple); the batch as it is without a mesh."""
        if self.mesh is None:
            return tree
        return rank_rows(tree, self.mesh.size, self.mesh.rank)

    def _gathered(self, preds: torch.Tensor) -> torch.Tensor:
        """[T, b, M] predictions of this rank's rows as the batch's [T, B, M]."""
        return preds if self.mesh is None else all_gather_tensor(preds.contiguous(), dim=1)

    def _lookup(self, feature: str, ids: torch.Tensor) -> torch.Tensor:
        t = self._tables[self.model.feature_to_table[feature]]
        idx = ids.long()
        if self._quantized:
            q, scale = t
            return q[idx].to(torch.float32) * scale[idx]
        return t[idx]

    @torch.inference_mode()
    def predict(
        self,
        uih_features: Dict[str, torch.Tensor],
        uih_lengths: torch.Tensor,
        candidates_features: Dict[str, torch.Tensor],
        num_candidates: torch.Tensor,
    ) -> torch.Tensor:
        """sparse -> dense; predictions [T, B, M] (under a mesh, of the
        request batch whose rows `shard_inputs` gave this rank)."""
        with span("serve.predict"):
            seq_embeddings, payloads = lookup_and_merge_features(
                self.cfg, self.model.feature_to_table, self._lookup,
                uih_features, uih_lengths, candidates_features,
            )
            return self._gathered(self.model.main_forward(
                seq_embeddings, payloads, uih_lengths, num_candidates, compute_losses=False
            )[3])

    @torch.inference_mode()
    def predict_mfalcon(
        self,
        uih_features: Dict[str, torch.Tensor],
        uih_lengths: torch.Tensor,
        candidates_features: Dict[str, torch.Tensor],
        query_time: torch.Tensor,
        microbatch: Optional[int] = None,
    ) -> torch.Tensor:
        """KV-cached scoring in chunks of ``microbatch`` (default
        ``max_num_candidates_inference``) candidates; predictions [T, B, M]."""
        m = microbatch or self.cfg.max_num_candidates_inference
        caches, _ = self.model.mfalcon_prefill(uih_features, uih_lengths, query_time)
        M = next(iter(candidates_features.values())).shape[1]
        preds = [
            self.model.mfalcon_score_chunk(
                caches, {k: v[:, c0 : c0 + m] for k, v in candidates_features.items()},
                query_time,
            )
            for c0 in range(0, M, m)
        ]
        return self._gathered(torch.cat(preds, dim=-1))
