"""Carry GA, SA, PT and Adam state across from the JAX package.

`load_jax_checkpoint` reads a `ga_ckpt.npz` written by the JAX package's
utils/checkpoint.save_checkpoint with numpy alone; `ga_state_from_jax`,
`sa_state_from_jax` and `pt_state_from_jax` build the port's GAState,
SAState and PTState from a JAX state's leaves. The port's random stream
cannot continue a jax.random key, so each state gets a torch.Generator
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
from .models.pt import PTState
from .models.sa import SAState

# the leaf order of the JAX package's GAState, SAState and PTState (the
# order its save_checkpoint writes)
GA_LEAVES = ("pop", "fits", "best", "best_fit", "no_improve", "key", "gen")
SA_LEAVES = ("curr", "curr_fit", "best", "best_fit", "key", "it")
PT_LEAVES = ("reps", "fits", "temps", "best", "best_fit", "key", "it")
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


def _leaves(leaves: Sequence[np.ndarray], names: Tuple[str, ...], what: str, device):
    """-> (leaves by name, name -> float32 tensor on device, a torch.Generator
    on device seeded from the jax.random key's words)."""
    if len(leaves) != len(names):
        raise ValueError(f"expected {len(names)} {what} leaves, got {len(leaves)}")
    arrs = dict(zip(names, leaves))
    dev = resolve_device(device)
    words = np.asarray(arrs["key"]).astype(np.uint64).reshape(-1)
    seed = int(sum(int(w) << (32 * i) for i, w in enumerate(words[:2])))
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)

    def f32(name):
        return torch.as_tensor(np.asarray(arrs[name], np.float32), device=dev)

    return arrs, f32, rng


def _genomes(t: torch.Tensor, name: str, dims: int) -> torch.Tensor:
    if t.dim() != dims or t.shape[-1] != 9:
        raise ValueError(f"{name} must have {dims} dims ending in 9, got {tuple(t.shape)}")
    return t


def ga_state_from_jax(leaves: Sequence[np.ndarray], device="cuda") -> GAState:
    """A JAX GAState's leaves (GA_LEAVES order) -> the port's GAState on `device`."""
    arrs, f32, rng = _leaves(leaves, GA_LEAVES, "GAState", device)
    return GAState(
        pop=_genomes(f32("pop"), "pop", 3),
        fits=f32("fits"),
        best=f32("best"),
        best_fit=f32("best_fit").reshape(()),
        no_improve=torch.as_tensor(
            np.asarray(arrs["no_improve"], np.int32), device=rng.device
        ).reshape(()),
        rng=rng,
        gen=int(np.asarray(arrs["gen"])),
    )


def sa_state_from_jax(leaves: Sequence[np.ndarray], device="cuda") -> SAState:
    """A JAX SAState's leaves (SA_LEAVES order) -> the port's SAState on `device`."""
    arrs, f32, rng = _leaves(leaves, SA_LEAVES, "SAState", device)
    return SAState(
        curr=_genomes(f32("curr"), "curr", 2),
        curr_fit=f32("curr_fit").reshape(()),
        best=f32("best"),
        best_fit=f32("best_fit").reshape(()),
        rng=rng,
        it=int(np.asarray(arrs["it"])),
    )


def pt_state_from_jax(leaves: Sequence[np.ndarray], device="cuda") -> PTState:
    """A JAX PTState's leaves (PT_LEAVES order) -> the port's PTState on `device`."""
    arrs, f32, rng = _leaves(leaves, PT_LEAVES, "PTState", device)
    return PTState(
        reps=_genomes(f32("reps"), "reps", 3),
        fits=f32("fits"),
        temps=f32("temps"),
        best=f32("best"),
        best_fit=f32("best_fit").reshape(()),
        rng=rng,
        it=int(np.asarray(arrs["it"])),
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
    group = state.opt.param_groups[0]
    state.opt.state[state.g] = {
        # a capturable or fused Adam (a card's) keeps its step count there
        "step": torch.tensor(float(n), dtype=torch.float32,
                             device=dev if group["capturable"] or group["fused"] else "cpu"),
        "exp_avg": f32(mu).reshape(g_t.shape),
        "exp_avg_sq": f32(nu).reshape(g_t.shape),
    }
    return state._replace(step=n)
