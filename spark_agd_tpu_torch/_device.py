"""Device choice for the port's entry points.

The port runs on the card unless the caller names the CPU.  With no CUDA
device and no explicit ``device="cpu"`` an entry point raises: a fit
that silently ran on the CPU would report CPU numbers as the card's.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device, or raise when there is none;
    anything else -> ``torch.device(device)`` (a CUDA device must exist)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU "
                "unless the caller passes device='cpu' explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available")
    return dev


def same_device(a, b) -> bool:
    """Whether ``a`` and ``b`` name one device, ``"cuda"`` standing for
    the current CUDA device (so ``"cuda"`` is a mesh's lead ``cuda:0``
    when that is the current device)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cuda" and a.index is None:
        a = torch.device("cuda", torch.cuda.current_device())
    if b.type == "cuda" and b.index is None:
        b = torch.device("cuda", torch.cuda.current_device())
    return a == b
