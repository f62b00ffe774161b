"""Sharded GA / Adam execution over a (pop, tile) mesh of processes.

PyTorch counterpart of `ggs_tpu/parallel/shard.py`. JAX partitions one
program over its mesh; here every rank runs the whole program on the whole
(replicated) state with the same seeded generator, so every rank draws the
same numbers and makes the same selection, and only the evaluation is
split (ops/objective.evaluate and models/gradient under `obj.mesh`): rank
(p, t) scores its pop shard's rows of the batch on its row slab of the
canvas, the slab partials come back by an all_reduce over the tile group
and the fits by an all_gather over the pop group (parallel/comm.py). Both
give the same bits on every rank, so the ranks stay identical (the
population is 590 KB at run_ga's defaults: replicating it costs nothing
that matters).

* `sharded_objective`: an Objective that evaluates over the mesh.
* `tile_rows` / `place_target` / `place_mask`: this rank's canvas rows and
  its rows of the target and mask (the JAX package commits them
  row-sharded over the tile axis); `pop_rows` / `place_pop`: this rank's
  rows of a batch.
* `migrate_ring`: island migration over the pop shards (shard.py:61-86), a
  local computation on the replicated population.
"""
from __future__ import annotations

from typing import Optional

import torch

from .mesh import Mesh


def sharded_objective(obj, mesh: Mesh):
    """obj (an ops/objective.Objective) evaluating over the mesh (shard.py:29-33)."""
    return obj._replace(mesh=mesh)


def tile_rows(H: int, mesh: Optional[Mesh]) -> slice:
    """This rank's canvas rows (H divides the tile axis)."""
    if mesh is None or mesh.tile_shards == 1:
        return slice(0, H)
    hs = H // mesh.tile_shards
    return slice(mesh.tile_index * hs, (mesh.tile_index + 1) * hs)


def pop_rows(n: int, mesh: Optional[Mesh]) -> slice:
    """This pop shard's rows of a batch of n (n divides the pop axis)."""
    if mesh is None or mesh.pop_shards == 1:
        return slice(0, n)
    b = n // mesh.pop_shards
    return slice(mesh.pop_index * b, (mesh.pop_index + 1) * b)


def place_pop(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[B, ...] -> this pop shard's rows [B / npop, ...] (a view)."""
    return g[pop_rows(g.shape[0], mesh)]


def place_target(target: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[H, W, 3] -> this rank's rows [H / ntile, W, 3] (a view)."""
    return target[tile_rows(target.shape[0], mesh)]


def place_mask(weight_mask: Optional[torch.Tensor], mesh: Mesh) -> Optional[torch.Tensor]:
    """[H, W] (or None) -> this rank's rows [H / ntile, W] (a view)."""
    if weight_mask is None:
        return None
    return weight_mask[tile_rows(weight_mask.shape[0], mesh)]


def migrate_ring(pop: torch.Tensor, fits: torch.Tensor, k: int, mesh: Mesh):
    """Island migration over the pop shards: shard i's k best (ties to the
    lower index, as lax.top_k keeps them) replace shard i+1's k worst, ring
    order, the population read as pop_shards blocks of P / pop_shards."""
    from .island import _migrate_roll

    return _migrate_roll(pop, fits, k, mesh.pop_shards)
