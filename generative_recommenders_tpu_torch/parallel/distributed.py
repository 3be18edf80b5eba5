"""Process-group bootstrap and the collectives of the distribution layer
(port of `generative_recommenders_tpu/parallel/distributed.py`).

One process drives one rank. `initialize_distributed` joins the process
group: over ``tcp://<coordinator>`` when a coordinator is given, else over
``env://`` (the variables ``torchrun`` sets). Unlike the JAX function, a
failed initialisation raises: a wrong coordinator must not train alone.

The collectives below are the only ones the port calls. Two of them carry a
gradient, so that a loss taken over the global batch differentiates on every
rank: `all_reduce_sum` (its backward all-reduces the cotangent) and
`all_gather_rows` (its backward sums each rank's cotangent of a slice on the
slice's owner). Inside `sharded_batch(group)` the losses' denominators and
batch statistics go through `batch_sum` / `batch_rows`, which reduce over
the ranks that hold the batch's rows; outside it they return their input.

Where the gloo backend meets CUDA tensors: every collective here runs on a
CUDA tensor directly, gloo staging it through the host itself (PyTorch's
gloo group has CUDA paths for all_reduce, all_gather and all_to_all_single).
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# how long a rank waits for the others at a collective before it raises
TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str = "cuda",
) -> None:
    """Joins the process group, once (a second call returns). The backend
    is ``nccl`` for ``device="cuda"`` and ``gloo`` on the CPU unless
    ``backend`` names one. On the card each rank takes device ``rank %
    device_count`` (several gloo ranks share one card). Raises on any
    failure."""
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        addr = coordinator_address
        init_method = addr if "://" in addr else f"tcp://{addr}"
        kw = dict(world_size=num_processes, rank=process_id)
    else:
        init_method, kw = "env://", {}
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; run on the CPU with device='cpu'")
        rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, timeout=TIMEOUT, **kw)
    logger.info(
        "distributed: rank %d of %d over %s (%s)", dist.get_rank(), dist.get_world_size(), backend, init_method
    )


def host_batch_shard() -> Tuple[int, int]:
    """(number of shards, this process's shard): (world size, rank), or
    (1, 0) without a process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def _solo(group) -> bool:
    """No collective runs: there is no process group, or ``group`` is a
    mesh row or column of one rank. The world group (None) runs its
    collectives even at one rank, so a one-rank run drives its backend."""
    return not dist.is_initialized() or (group is not None and dist.get_world_size(group) == 1)


# ------------------------------------------------------------- collectives
def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sums ``t`` in place over ``group``; returns it."""
    if not _solo(group):
        dist.all_reduce(t, group=group)
    return t


def all_gather_tensor(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along ``dim`` in rank
    order. No gradient."""
    if _solo(group):
        return t
    n = group_size(group)
    t = t.movedim(dim, 0).contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out.movedim(0, dim)


def all_to_all(
    t: torch.Tensor, send_counts: Sequence[int], recv_counts: Sequence[int], group=None
) -> torch.Tensor:
    """Rows ``t[sum(send_counts[:k]) : ...]`` go to rank k of ``group``; the
    result holds what each rank sent here, in rank order."""
    if _solo(group):
        return t
    out = t.new_empty((int(sum(recv_counts)),) + tuple(t.shape[1:]))
    dist.all_to_all_single(
        out, t.contiguous(), output_split_sizes=list(recv_counts), input_split_sizes=list(send_counts), group=group
    )
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone(), ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.rows = group, t.shape[0]
        return all_gather_tensor(t, group)

    @staticmethod
    def backward(ctx, g):
        # every rank's cotangent of every slice, summed on the slice's owner
        g = all_reduce_sum_(g.contiguous().clone(), ctx.group)
        r = group_rank(ctx.group)
        return g[r * ctx.rows : (r + 1) * ctx.rows], None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``, differentiable."""
    return t if _solo(group) else _AllReduceSum.apply(t, group)


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``t`` stacked along dim 0 in rank order, differentiable."""
    return t if _solo(group) else _AllGatherRows.apply(t, group)


# ------------------------------------------------------ the global batch
_BATCH_GROUPS: List = []


@contextlib.contextmanager
def sharded_batch(group=None) -> Iterator[None]:
    """Within the block the batch's rows are spread over ``group`` (None:
    every rank), so `batch_sum`, `batch_rows` and `batch_ranks` reduce over
    it."""
    _BATCH_GROUPS.append(group)
    try:
        yield
    finally:
        _BATCH_GROUPS.pop()


def _batch_group():
    return _BATCH_GROUPS[-1] if _BATCH_GROUPS else None


def batch_ranks() -> int:
    """How many ranks hold rows of the batch (1 outside `sharded_batch`)."""
    return group_size(_batch_group()) if _BATCH_GROUPS else 1


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks that hold the batch, differentiable."""
    return all_reduce_sum(t, _batch_group()) if _BATCH_GROUPS else t


def batch_rows(t: torch.Tensor) -> torch.Tensor:
    """The batch's rows of ``t`` from every rank, in rank order,
    differentiable."""
    return all_gather_rows(t, _batch_group()) if _BATCH_GROUPS else t


def sum_gradients(dense: Sequence[torch.Tensor], whole: Sequence[torch.Tensor], loss: torch.Tensor) -> torch.Tensor:
    """Sums the parameters' gradients over the world, in a fixed order: the
    ``dense`` ones flattened into one buffer with ``loss`` (this rank's share
    of the global loss), then each of the ``whole`` (large) ones alone.
    Returns the global loss."""
    flat = all_reduce_sum_(torch.cat([p.grad.reshape(-1) for p in dense] + [loss.reshape(1)]))
    for p, g in zip(dense, torch.split(flat[:-1], [p.numel() for p in dense])):
        p.grad.copy_(g.view_as(p))
    for p in whole:
        all_reduce_sum_(p.grad)
    return flat[-1]
