"""The plain reference of the memetic GA's refinement (ggs_tpu_torch's
gradient.make_refine, which ga.make_memetic_run_block holds): plain
PyTorch in float32, no kernel and no part of the program.

Each elite takes `steps` projected Adam steps from fresh moments
(portbench.reference.follow_adam), and is then scored by
portbench.reference.energies; the refined genome is kept only where its
energy is lower than the elite's fit, as make_refine keeps it.

The program takes one Adam over the batch of elites, on the gradient of
the mean of their energies (render_grad.fused_value_and_grad), so each
elite's gradient reaches Adam divided by E, the number of elites. Adam
divides its first moment by the root of its second, so the same steps
follow from each elite's own gradient with eps times E:
lr m / (sqrt(v) + eps) with m and sqrt(v) both divided by E is
lr m / (sqrt(v) + E eps). follow_adam is called so.
"""
from __future__ import annotations

import torch

from . import reference

EPS = 1e-8  # torch.optim.Adam's eps, as gradient.make_adam sets it


def refine(elites: torch.Tensor, fits: torch.Tensor, target, mask, H: int, W: int, steps: int,
           lr: float, k_sigma: float = 3.0, b1: float = 0.9, b2: float = 0.999,
           dtype=torch.float32):
    """Elites [E, N, 9] with their fits [E] -> (the refined genomes
    [E, N, 9], their energies [E] float64, the kept mask [E] bool: where
    the energy is below the fit, and the first step's gradient of each
    elite's own energy [E, N, 9]). The refinement's result is the refined
    genome where kept and the elite where not. `dtype=torch.bfloat16`
    computes the walks in bfloat16 (reference.follow_adam, energies)."""
    E = elites.shape[0]
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        refined, firsts = [], []
        for el in elites:
            _, first, g = reference.follow_adam(el, target, mask, H, W, steps, lr, b1=b1, b2=b2,
                                                eps=EPS * E, k_sigma=k_sigma, dtype=dtype)
            refined.append(g)
            firsts.append(first)
        refined = torch.stack(refined)
        energies = reference.energies(refined, target, mask, H, W, k_sigma, dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    kept = energies < fits.double().to(energies.device)
    return refined, energies, kept, torch.stack(firsts)
