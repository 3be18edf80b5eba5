"""Row-sharded embedding tables with an all-to-all id / vector exchange (port
of `generative_recommenders_tpu/parallel/embedding.py`).

A table is row-sharded over the mesh's model axis: model rank j holds rows
``[j R/m, (j + 1) R/m)``. Every rank arrives at the lookup with the ids of
its own batch rows. Within its model group (the m ranks of its data row) the
lookup

1. sorts its ids by owner (``id // (R/m)``, a stable sort);
2. gathers every rank's send counts into the exchange matrix ``M[s, d]``
   (ids rank s sends to owner d);
3. sends the ids to their owners with ``all_to_all_single`` at those exact
   sizes (the JAX package's "ragged" route);
4. gathers the received ids' rows from the local shard (a zero row for an id
   outside it);
5. sends the vectors back with the reverse ``all_to_all_single`` and
   unsorts them.

The fixed-capacity "dense" route sends every rank a slot per id (L slots to
each of the m owners, unused slots filled with an id no shard holds), as
the JAX package does on the CPU; it needs no count exchange and gives the
same numbers. ``impl="auto"`` takes the ragged route, which every
``torch.distributed`` backend runs.

The backward sends each cotangent to its id's owner through the same
exchange (the forward's routing, kept), adds them into a zero gradient of
the shard (``index_put_`` with ``accumulate``: deterministic under
`torch.use_deterministic_algorithms`), then sums it over the data group,
whose ranks hold the same shard. So a shard only ever receives the rows it
owns, and row-wise Adagrad steps it alone (`rowwise_adagrad_update`, or the
trainers' `RowWiseAdagrad` on the shard parameter). The local gather and
scatter are ``index_select`` and ``index_put_``, as the JAX package leaves
its ``take`` and ``.at[].add`` to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from generative_recommenders_tpu_torch.modules.mlp import truncated_normal
from generative_recommenders_tpu_torch.parallel.distributed import (
    all_gather_tensor,
    all_reduce_sum_,
    all_to_all,
)
from generative_recommenders_tpu_torch.parallel.mesh import Mesh
from generative_recommenders_tpu_torch.parallel.sharding import shard_rows


class ShardedEmbeddingState(NamedTuple):
    """A table's row block on this rank and its row-wise Adagrad
    accumulator (torchrec's sharded table with its fused optimizer state)."""

    table: torch.Tensor  # [R / m, D]
    accumulator: torch.Tensor  # [R / m]


def create_sharded_embedding(
    gen: Optional[torch.Generator], num_rows: int, dim: int, mesh: Mesh, stddev: float = 0.02,
    device: Optional[torch.device] = None,
) -> ShardedEmbeddingState:
    """The whole table drawn from ``gen`` (truncated normal, as every rank
    draws it), of which this rank keeps its row block."""
    if num_rows % mesh.model_size:
        raise ValueError(f"num_rows {num_rows} must be divisible by model shards {mesh.model_size}")
    full = torch.empty((num_rows, dim), device=device)
    truncated_normal(stddev)(full, gen)
    table = shard_rows(full, mesh).clone()
    return ShardedEmbeddingState(table, table.new_zeros(table.shape[0]))


# ------------------------------------------------------------------ routing
@dataclasses.dataclass
class _Route:
    """What both directions of one exchange need: this rank's ids in owner
    order and, on the owner's side, the local row each received id reads."""

    order: torch.Tensor  # int[L]: the sort by owner
    local: torch.Tensor  # int[received]: the row in the shard (0 where none)
    hit: torch.Tensor  # bool[received, 1]: the shard holds the id
    send_counts: List[int]  # ragged: ids sent to each owner
    recv_counts: List[int]  # ragged: ids received from each rank
    slot: Optional[torch.Tensor]  # dense: the sorted ids' slots in the [m L] buffer


def _route(flat_ids: torch.Tensor, mesh: Mesh, rows_local: int, impl: str) -> _Route:
    m, j, group = mesh.model_size, mesh.model_index, mesh.model_group
    owner = torch.div(flat_ids, rows_local, rounding_mode="floor").clamp_(0, m - 1)
    order = torch.argsort(owner, stable=True)
    sorted_ids = flat_ids[order]
    send = torch.bincount(owner, minlength=m)
    if impl == "ragged":
        M = all_gather_tensor(send, group).reshape(m, m).tolist()  # M[s][d], one host read
        send_counts, recv_counts = M[j], [row[j] for row in M]
        recv_ids, slot = all_to_all(sorted_ids, send_counts, recv_counts, group), None
    elif impl == "dense":
        L = flat_ids.numel()
        sorted_owner = owner[order]
        send_off = torch.cumsum(send, 0) - send
        slot = sorted_owner * L + torch.arange(L, device=flat_ids.device) - send_off[sorted_owner]
        # unused slots ask for row R, which no shard holds
        buf = flat_ids.new_full((m * L,), m * rows_local).index_copy_(0, slot, sorted_ids)
        send_counts = recv_counts = [L] * m
        recv_ids = all_to_all(buf, send_counts, recv_counts, group)
    else:
        raise ValueError(f"Unknown exchange impl {impl}")
    local = recv_ids - j * rows_local
    hit = (local >= 0) & (local < rows_local)
    return _Route(order, torch.where(hit, local, 0), hit[:, None], send_counts, recv_counts, slot)


def _gather(table: torch.Tensor, r: _Route, mesh: Mesh) -> torch.Tensor:
    """The rows of this rank's ids [L, D], in its ids' order."""
    vecs = torch.where(r.hit, table.index_select(0, r.local), 0)
    back = all_to_all(vecs, r.recv_counts, r.send_counts, mesh.model_group)
    if r.slot is not None:
        back = back.index_select(0, r.slot)
    return torch.empty_like(back).index_copy_(0, r.order, back)


def _scatter(g: torch.Tensor, r: _Route, mesh: Mesh, rows_local: int) -> torch.Tensor:
    """The shard's gradient [R / m, D] from every rank's cotangents [L, D],
    summed over the data group."""
    sorted_g = g.index_select(0, r.order)
    if r.slot is not None:
        sorted_g = sorted_g.new_zeros((r.slot.numel() * mesh.model_size, g.shape[1])).index_copy_(
            0, r.slot, sorted_g
        )
    recv_g = all_to_all(sorted_g, r.send_counts, r.recv_counts, mesh.model_group)
    d_local = torch.zeros((rows_local, g.shape[1]), dtype=torch.float32, device=g.device)
    d_local.index_put_((r.local,), torch.where(r.hit, recv_g.float(), 0), accumulate=True)
    return all_reduce_sum_(d_local, mesh.data_group).to(g.dtype)


class _ShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, flat_ids, mesh, impl):
        ctx.route = _route(flat_ids, mesh, table.shape[0], impl)
        ctx.mesh, ctx.rows_local = mesh, table.shape[0]
        return _gather(table, ctx.route, mesh)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g.contiguous(), ctx.route, ctx.mesh, ctx.rows_local), None, None, None


def _resolve_impl(impl: str) -> str:
    return "ragged" if impl == "auto" else impl


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh, impl: str = "auto") -> torch.Tensor:
    """The rows of ``ids`` (any shape; this rank's batch rows) -> [..., D].
    ``table`` is this rank's row block of a table sharded over the model
    axis; on a mesh of one model rank it is the whole table and the lookup
    is a local gather. Differentiable in ``table``. The trainers bind it only
    to the tables they sharded: one that does not divide the model axis stays
    whole and is read with a local gather, as in the JAX package."""
    if mesh.model_size == 1:
        return F.embedding(ids.long(), table)
    flat = ids.reshape(-1).long()
    out = _ShardedLookup.apply(table, flat, mesh, _resolve_impl(impl))
    return out.reshape(tuple(ids.shape) + (table.shape[1],))


def grad_exchange(ids: torch.Tensor, grads: torch.Tensor, mesh: Mesh, rows_local: int, impl: str = "auto"):
    """The shard's gradient [R / m, D] from per-occurrence cotangents
    ``grads`` [..., D] of ``ids`` [...]: the lookup's backward exchange
    alone, without a forward."""
    flat = ids.reshape(-1).long()
    g = grads.reshape(flat.numel(), -1)
    return _scatter(g, _route(flat, mesh, rows_local, _resolve_impl(impl)), mesh, rows_local)


@torch.no_grad()
def rowwise_adagrad_update(
    state: ShardedEmbeddingState,
    ids: torch.Tensor,
    grads: torch.Tensor,
    mesh: Mesh,
    lr: float = 0.01,
    eps: float = 1e-8,
    impl: str = "auto",
) -> ShardedEmbeddingState:
    """torchrec's RowWiseAdagrad on the shard (``acc += mean(g^2)``, ``row -=
    lr / (sqrt(acc) + eps) g``) from per-occurrence cotangents; duplicate ids
    add up. The gradient comes from the lookup's backward exchange directly
    (`grad_exchange`); the update is local."""
    rows, dim = state.table.shape
    if mesh.model_size == 1:
        g_table = torch.zeros_like(state.table).index_put_(
            (ids.reshape(-1).long(),), grads.reshape(-1, dim), accumulate=True
        )
    else:
        g_table = grad_exchange(ids, grads, mesh, rows, impl)
    acc = state.accumulator + g_table.square().mean(dim=1)
    table = state.table - (lr / (acc.sqrt() + eps))[:, None] * g_table
    return ShardedEmbeddingState(table, acc)
