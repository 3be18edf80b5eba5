"""Which parameters are row-sharded, and which rows of a batch a rank takes
(port of the rules of `generative_recommenders_tpu/parallel/sharding.py`;
the JAX package states them as sharding objects, here they are the slices
each rank keeps).

* A table is a 2-D parameter whose name holds one of ``_TABLE_PATH_KEYS``
  (the rule `parallel/optimizers.py:param_labels` uses too). A table that
  the lookup reads is row-sharded over the model axis when its rows divide
  m: model rank j keeps rows ``[j R/m, (j + 1) R/m)``. A table that does not
  divide m stays whole on every rank, as in the JAX package. The rule also
  matches the 2-D kernels of DlrmHSTU's ``item_embedding_mlp``; GSPMD lays
  them out by rows, which does not change what they compute, and the port
  keeps them whole.
* The batch is spread over every rank of the mesh: rank k takes rows
  ``[k b, (k + 1) b)`` of each global batch of ``n b`` rows (``P((data,
  model))`` in the JAX package, and `batch_iterator(...,
  shard_contiguous=True)`).
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Tuple

import torch

from generative_recommenders_tpu_torch.parallel.mesh import Mesh

# name fragments that mark a table (`parallel/sharding.py:_TABLE_PATH_KEYS`)
_TABLE_PATH_KEYS = ("embedding_module", "embedding_tables", "item_embedding")


def is_table_path(name: str) -> bool:
    return any(k in name for k in _TABLE_PATH_KEYS)


def row_shardable(mesh: Mesh, p: torch.Tensor) -> bool:
    """A 2-D parameter whose rows divide the model axis."""
    return p.dim() == 2 and p.shape[0] % mesh.model_size == 0


def pad_vocab_to(num_items: int, mesh_model_size: int) -> int:
    """The smallest vocabulary whose table (with the padding row) divides
    the model axis."""
    rows = num_items + 1
    return ((rows + mesh_model_size - 1) // mesh_model_size) * mesh_model_size - 1


def shard_rows(full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's row block of a row-sharded tensor."""
    n = full.shape[0] // mesh.model_size
    j = mesh.model_index
    return full[j * n : (j + 1) * n]


def shard_tables(model: torch.nn.Module, names: Iterable[str], mesh: Mesh) -> Tuple[str, ...]:
    """Replaces each named table that divides the model axis by this rank's
    row block (in place, so optimizers built later see the shard); returns
    the names it sharded. Nothing is sharded on a mesh of one model rank."""
    if mesh.model_size == 1:
        return ()
    params = dict(model.named_parameters())
    sharded = []
    for name in names:
        p = params[name]
        if is_table_path(name) and row_shardable(mesh, p):
            p.data = shard_rows(p.data, mesh).clone()
            sharded.append(name)
    return tuple(sharded)


def rank_rows(x: Any, num_shards: int, shard_index: int) -> Any:
    """Rows ``[k b, (k + 1) b)`` of every array of a (nested) batch, where
    b = rows / ``num_shards`` and k = ``shard_index``."""
    if isinstance(x, dict):
        return {k: rank_rows(v, num_shards, shard_index) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(rank_rows(v, num_shards, shard_index) for v in x)
    n = x.shape[0]
    if n % num_shards:
        raise ValueError(f"a batch of {n} rows does not split over {num_shards} ranks")
    b = n // num_shards
    return x[shard_index * b : (shard_index + 1) * b]


def shard_batches(batches: Iterator[Any], num_shards: int, shard_index: int) -> Iterator[Any]:
    """Each global batch of ``batches`` cut to this rank's rows."""
    for batch in batches:
        yield rank_rows(batch, num_shards, shard_index)
