"""Typed configuration for the PyTorch port.

The port's own copy of the dataclasses it needs from the JAX package's
`ggs_tpu/config.py`, with the same fields and defaults, so that the two
packages configure a run the same way without one importing the other.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MutSigma:
    """Per-gene-group mutation sigmas (reference: modules/config.py:27-43)."""

    xy: float = 0.1
    alog: float = 0.5
    blog: float = 0.5
    theta: float = 0.3
    rgb: float = 25.0
    alpha: float = 25.0

    @staticmethod
    def max_defaults() -> "MutSigma":
        return MutSigma()

    @staticmethod
    def min_defaults() -> "MutSigma":
        return MutSigma(xy=0.01, alog=0.05, blog=0.05, theta=0.025, rgb=2.0, alpha=2.0)


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    """Importance-mask settings (reference: modules/mask.py:29-40, config.py:49-50)."""

    edge_scales: Tuple[int, ...] = (1, 2, 4)
    w_edge: float = 0.7
    w_var: float = 0.3
    gamma: float = 0.7
    floor: float = 0.15
    smooth: int = 3
    strength: float = 0.7
    boost_only: bool = False
    boost_beta: float = 1.0


@dataclasses.dataclass(frozen=True)
class GenomeConfig:
    """Splat-set shape and bounds (reference: modules/config.py:6,23-24)."""

    n_splats: int = 512
    min_scale: float = 3.0  # min sigma, pixels (MIN_SCALE_SPLATS)
    max_scale: float = 0.1  # max sigma, fraction of max(H, W) (MAX_SCALE_SPLATS)


@dataclasses.dataclass(frozen=True)
class GAConfig:
    """Genetic-algorithm settings (reference: modules/config.py:6-15,46)."""

    pop_size: int = 32
    generations: int = 500_000
    tour_k: int = 2
    elite_k: int = 8
    cxpb: float = 0.05
    mutpb: float = 0.05
    schedule: str = "cosine"  # sigma anneal: "cosine" | "linear" | "exp"
    # Elite fitness is cached (it is deterministic); True re-renders the
    # elites every generation like the reference (algorithm.py:129-137).
    reeval_elites: bool = False


@dataclasses.dataclass(frozen=True)
class SAConfig:
    """Simulated-annealing settings (reference: modules/config.py:71-73)."""

    iterations: int = 500_000
    tries_per_iter: int = 8
    t0: float = 1e-3
    temp_schedule: str = "cosine"  # "exp"|"linear"|"cosine"|"log"|"cauchy"
    sigma_schedule: str = "cosine"
    mutpb: float = 0.05
    # "batched": all tries proposed from the iteration-start state, scored as
    # one batch, then Metropolis-accepted in order; "sequential": each try
    # mutates the possibly-updated state (the reference's chaining,
    # annealing.py:121-146), scored one at a time
    proposal_mode: str = "batched"


@dataclasses.dataclass(frozen=True)
class GradConfig:
    """Gradient-descent fitting (projected Adam; no reference analogue)."""

    steps: int = 2000
    lr: float = 1e-2
    b1: float = 0.9
    b2: float = 0.999
    remat_chunk: int = 64  # the JAX package's oracle remat chunk (unused here)
