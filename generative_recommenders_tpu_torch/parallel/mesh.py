"""The (data, model) mesh over the ranks of a process group (port of
`generative_recommenders_tpu/parallel/mesh.py`).

Rank k sits at ``(k // m, k % m)`` of a ``(d, m)`` mesh, where the JAX
package places device k (``np.asarray(devices).reshape(shape)``).

* "model": the m ranks of one data row. The embedding tables are
  row-sharded across them; the lookup's all-to-all exchange runs inside
  this group (`parallel/embedding.py`).
* "data": the d ranks of one model column. They hold the same table shard,
  so a shard's gradient is summed across this group.

The batch is spread over all d x m ranks: rank k takes rows ``[k b, (k + 1)
b)`` of a global batch of ``d m b`` rows (`parallel/sharding.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(d, m)`` mesh and this rank's place in it. The groups are None
    where the mesh has one rank (no collective runs)."""

    shape: Tuple[int, int]
    coords: Tuple[int, int]  # (data index, model index) of this rank
    model_group: Optional[Any] = None  # the m ranks of this rank's data row
    data_group: Optional[Any] = None  # the d ranks of this rank's model column

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def rank(self) -> int:
        return self.coords[0] * self.shape[1] + self.coords[1]

    @property
    def model_size(self) -> int:
        return self.shape[1]

    @property
    def model_index(self) -> int:
        return self.coords[1]


def make_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """The ``(d, m)`` mesh over the process group's ranks (one rank without a
    process group); ``shape=None`` puts every rank on the data axis. A shape
    whose product is not the world size raises. Every rank builds every row
    and column group in the same order (`new_group` is collective)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    d, m = shape if shape is not None else (world, 1)
    if d * m != world:
        raise ValueError(f"mesh shape {(d, m)} != {world} ranks")
    coords = (rank // m, rank % m)
    if world == 1:
        return Mesh((d, m), coords)
    model_group = data_group = None
    for i in range(d):
        g = dist.new_group([i * m + j for j in range(m)])
        if i == coords[0]:
            model_group = g
    for j in range(m):
        g = dist.new_group([i * m + j for i in range(d)])
        if j == coords[1]:
            data_group = g
    return Mesh((d, m), coords, model_group, data_group)


def parse_mesh(spec: str) -> Tuple[int, int]:
    """``"DxM"`` (e.g. ``"4x2"``) as ``(D, M)``."""
    d, m = (int(x) for x in spec.lower().split("x"))
    return d, m
