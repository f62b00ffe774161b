"""Carry GA and Adam state across from the JAX package.

`load_jax_checkpoint` reads a `ga_ckpt.npz` written by the JAX package's
utils/checkpoint.save_checkpoint with numpy alone; `ga_state_from_jax`
builds the port's GAState from those leaves. The port's random stream
cannot continue a jax.random key, so the state gets a torch.Generator
seeded from the key's words. `grad_state_from_jax` builds the port's
GradState (genomes plus a torch.optim.Adam holding optax's moments) from
a JAX GradState's arrays.
"""
from __future__ import annotations

import functools
import json
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import resolve_device
from .config import GradConfig
from .models import gradient
from .models.ga import GAState

# GAState leaf order of the JAX package's save_checkpoint
GA_LEAVES = ("pop", "fits", "best", "best_fit", "no_improve", "key", "gen")
_MAX_FORMAT_VERSION = 2


def load_jax_checkpoint(path: str) -> Tuple[List[np.ndarray], Dict[str, Any]]:
    """-> (leaves in saved order, meta dict)."""
    with np.load(path, allow_pickle=False) as z:
        payload = json.loads(str(z["__meta__"]))
        n = int(payload["num_leaves"])
        leaves = [np.asarray(z[f"leaf_{i}"]) for i in range(n)]
    version = int(payload.get("format_version", 1))
    if version > _MAX_FORMAT_VERSION:
        raise ValueError(f"checkpoint {path!r} has format v{version}; this reads <= v2")
    return leaves, payload.get("meta", {})


def ga_state_from_jax(leaves: Sequence[np.ndarray], device="cuda") -> GAState:
    """A JAX GAState's leaves (GA_LEAVES order) -> the port's GAState on `device`."""
    if len(leaves) != len(GA_LEAVES):
        raise ValueError(f"expected {len(GA_LEAVES)} GAState leaves, got {len(leaves)}")
    arrs = dict(zip(GA_LEAVES, leaves))
    dev = resolve_device(device)
    pop = torch.as_tensor(np.asarray(arrs["pop"], np.float32), device=dev)
    if pop.dim() != 3 or pop.shape[2] != 9:
        raise ValueError(f"pop must be [P, N, 9], got {tuple(pop.shape)}")
    words = np.asarray(arrs["key"]).astype(np.uint64).reshape(-1)
    seed = int(sum(int(w) << (32 * i) for i, w in enumerate(words[:2])))
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)

    def f32(name):
        return torch.as_tensor(np.asarray(arrs[name], np.float32), device=dev)

    return GAState(
        pop=pop,
        fits=f32("fits"),
        best=f32("best"),
        best_fit=f32("best_fit").reshape(()),
        no_improve=torch.as_tensor(np.asarray(arrs["no_improve"], np.int32), device=dev).reshape(()),
        rng=rng,
        gen=int(np.asarray(arrs["gen"])),
    )


def grad_state_from_jax(g, mu, nu, count, cfg: GradConfig = GradConfig(), device="cuda"):
    """A JAX GradState's genomes g [B, N, 9] and optax ScaleByAdamState
    (mu, nu, count), as numpy arrays -> the port's GradState on `device`,
    whose Adam (lr, b1, b2 from cfg) holds step = count, exp_avg = mu and
    exp_avg_sq = nu, so the next step is the one optax would take."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)

    g_t = f32(g)
    if g_t.dim() != 3 or g_t.shape[2] != 9:
        raise ValueError(f"g must be [B, N, 9], got {tuple(g_t.shape)}")
    state = gradient.init_state(functools.partial(gradient.make_adam, cfg=cfg), g_t)
    n = int(np.asarray(count))
    state.opt.state[state.g] = {
        "step": torch.tensor(float(n), dtype=torch.float32),
        "exp_avg": f32(mu).reshape(g_t.shape),
        "exp_avg_sq": f32(nu).reshape(g_t.shape),
    }
    return state._replace(step=n)
