"""The collectives of the sharded paths, over a Mesh's pop and tile groups.

Only `all_reduce` and `all_gather` are used: gloo, the backend of ranks
that share one card, takes CUDA tensors for both (staging them through host
memory itself), where its send/recv take CPU tensors only. A group of one
rank is the identity, with no call. Every rank of a group makes the same
calls in the same order, and both collectives leave the same bits on every
rank, so the replicated state stays identical.

* `tile_sum`: the sum over the tile group (no gradient).
* `psum`: the same as an autograd Function whose backward returns the
  cotangent unchanged. Every rank holds the same loss, so after `backward`
  each rank has the gradient of its own slab's partials; one all_reduce of
  the genome gradient over the tile group then gives the whole canvas's,
  which is what shard_map's transpose gives JAX (gradient.py:135-150).
  (torch.distributed.nn.functional.all_reduce all-reduces the cotangent in
  its backward, which would scale that gradient by ntile.)
* `halo_next`: rank i receives rank i+1's (mod ntile) tensor, the SSIM halo
  of objective.py:246-248; the backward sends each halo's cotangent back to
  the rank that owns those rows.
* `pop_gather`: this pop shard's rows, concatenated over the pop group.

`BYTES` counts the bytes each call puts into a collective on this rank (its
own contribution; the tools print them per generation).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

BYTES = {"all_reduce": 0, "all_gather": 0}


def _size(group) -> int:
    return dist.get_world_size(group)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, group=group)
    BYTES["all_reduce"] += _nbytes(out)
    return out


def _all_gather(x: torch.Tensor, group) -> list:
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x, group=group)
    BYTES["all_gather"] += _nbytes(x)
    return parts


def tile_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over the mesh's tile group (the same bits on every rank)."""
    if mesh is None or mesh.tile_shards == 1:
        return x
    return _all_reduce(x, mesh.tile_group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """tile_sum whose backward passes the cotangent through unchanged."""
    if mesh is None or mesh.tile_shards == 1:
        return x
    return _PSum.apply(x, mesh.tile_group)


class _HaloNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        parts = _all_gather(x, mesh.tile_group)
        return parts[(mesh.tile_index + 1) % mesh.tile_shards]

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        # rank i's cotangent belongs to rank i+1's rows: rank j takes rank j-1's
        parts = _all_gather(g, mesh.tile_group)
        return parts[(mesh.tile_index - 1) % mesh.tile_shards], None


def halo_next(x: torch.Tensor, mesh) -> torch.Tensor:
    """The next tile rank's x (ring order; one rank receives its own)."""
    if mesh is None or mesh.tile_shards == 1:
        return x
    return _HaloNext.apply(x, mesh)


def pop_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """This pop shard's rows x, concatenated in pop order over the pop group."""
    if mesh is None or mesh.pop_shards == 1:
        return x
    return torch.cat(_all_gather(x, mesh.pop_group), dim=0)
