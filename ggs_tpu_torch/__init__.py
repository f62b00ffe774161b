"""ggs_tpu_torch: the PyTorch/CUDA port of ggs_tpu.

Gaussian-splat image approximation on an NVIDIA H100. Plain tensor code is
PyTorch; the tile walks that the JAX package wrote in Pallas are CUDA
kernels under `csrc/`, built with nvcc at first use. Entry points run on
the card (`device="cuda"`) unless the caller asks for the CPU, where every
kernel wrapper runs its plain PyTorch version.
"""
import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; asking for CUDA without a card raises
    instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU"
        )
    return dev
