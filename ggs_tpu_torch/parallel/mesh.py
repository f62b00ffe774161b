"""(pop, tile) grid of the ranks of one torch.distributed world.

PyTorch counterpart of `ggs_tpu/parallel/mesh.py`. The JAX package runs one
program over a device mesh; the port runs one process per rank, each
holding the whole GA or Adam state (replicated), and splits only the
evaluation:

* `pop` axis: rank (p, t) scores rows [p*B/npop, (p+1)*B/npop) of the
  batch; the fits come back by an all_gather over the pop group.
* `tile` axis: rank (p, t) renders canvas rows [t*H/ntile, (t+1)*H/ntile);
  the slab partials (and in gradient mode the genome gradients) come back
  by an all_reduce over the tile group.

Rank r sits at (r // ntile, r % ntile), the layout of
`np.arange(n).reshape(pop, tile)` (mesh.py:44). The backend is NCCL when
each rank has a card of its own, gloo otherwise: on the CPU, and when
several ranks share one card (NCCL runs no two ranks on one device).

    torchrun --standalone --nproc-per-node 4 -m ggs_tpu_torch.run_ga \\
        --pop-shards 2 --tile-shards 2
"""
from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """This rank's place in the (pop, tile) grid and its two groups."""

    pop_shards: int
    tile_shards: int
    rank: int
    pop_index: int  # this rank's pop shard: its rows of the batch
    tile_index: int  # this rank's row slab of the canvas
    pop_group: object  # the ranks of this rank's tile column (same slab)
    tile_group: object  # the ranks of this rank's pop row (same batch rows)
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        """Rank 0 prints the log and writes the artifacts."""
        return self.rank == 0


def launch_hint(n: int, module: str = "ggs_tpu_torch.run_ga") -> str:
    return f"torchrun --standalone --nproc-per-node {n} -m {module} ..."


def distributed_init(
    device="cuda",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> torch.device:
    """Join (or reuse) the process group -> this rank's device.

    Under torchrun the group comes from its environment (`env://`); the tests
    pass an explicit `init_method` (a `file://` store), world_size and rank.
    Without either it raises: a sharded run never quietly runs one process.
    The device is `cuda:{local_rank % device_count}` (or the CPU); the
    backend NCCL when every rank on this host has a card of its own, else
    gloo."""
    dev = torch.device(device)
    if init_method is None and not dist.is_initialized() and "RANK" not in os.environ:
        raise RuntimeError(
            "sharding needs a torch.distributed process group: launch with "
            f"`{launch_hint(2)}` (one process per rank)")
    if init_method is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))
    else:  # an explicit world is one host's
        local_rank, local_world = int(rank), int(world_size)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(dev)!r} was asked for but torch.cuda.is_available() "
                               "is False; pass device='cpu'")
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
        backend = "nccl" if count >= local_world else "gloo"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        if init_method is None:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=init_method, world_size=int(world_size),
                                    rank=int(rank))
    return dev


def make_mesh(pop_shards: int = 1, tile_shards: int = 1, device="cuda", **init_kw) -> Mesh:
    """The (pop, tile) grid over the whole world (joined by distributed_init
    if need be). Raises ValueError unless the world has pop_shards *
    tile_shards ranks. Every rank creates every pop group and every tile
    group, in the same order, as torch.distributed requires."""
    if pop_shards < 1 or tile_shards < 1:
        raise ValueError(f"shards must be >= 1, got pop {pop_shards} x tile {tile_shards}")
    dev = distributed_init(device, **init_kw)
    n = pop_shards * tile_shards
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"the mesh pop={pop_shards} x tile={tile_shards} needs {n} ranks, the "
                         f"world has {world} (launch with `{launch_hint(n)}`)")
    grid = np.arange(n).reshape(pop_shards, tile_shards)
    rank = dist.get_rank()
    pi, ti = int(rank // tile_shards), int(rank % tile_shards)
    pop_groups = [dist.new_group([int(r) for r in grid[:, t]]) for t in range(tile_shards)]
    tile_groups = [dist.new_group([int(r) for r in grid[p, :]]) for p in range(pop_shards)]
    backend = str(dist.get_backend())
    mesh = Mesh(pop_shards, tile_shards, rank, pi, ti, pop_groups[ti], tile_groups[pi], dev,
                backend)
    if mesh.is_main:
        share = "each rank its own card" if backend == "nccl" else (
            "ranks share " + str(dev) if dev.type == "cuda" else "CPU")
        print(f"mesh: pop={pop_shards} x tile={tile_shards} over {world} ranks, backend "
              f"{backend} ({share})", flush=True)
    return mesh


def auto_mesh(n_devices: Optional[int] = None, device="cuda", **init_kw) -> Mesh:
    """Split the world between the pop and tile axes, pop-major: a tile axis
    of 2 or 4 where the pop axis stays at least as large (mesh.py:50-59)."""
    if n_devices is None:
        distributed_init(device, **init_kw)
        n_devices = dist.get_world_size()
    tile = 1
    for cand in (2, 4):
        if n_devices % cand == 0 and n_devices // cand >= cand:
            tile = cand
    return make_mesh(n_devices // tile, tile, device, **init_kw)


@contextlib.contextmanager
def runner_mesh(pop_shards: int, tile_shards: int, device="cuda"):
    """A runner's mesh for its --pop-shards / --tile-shards (None for one
    shard). A process group that this call joins (torchrun's) is destroyed
    on leaving, so each rank tears gloo's threads down in order before the
    interpreter exits; one that was there before (a caller's) stays."""
    if pop_shards * tile_shards == 1:
        yield None
        return
    joined = not dist.is_initialized()
    mesh = make_mesh(pop_shards, tile_shards, device)
    try:
        yield mesh
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()
