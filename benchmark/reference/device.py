"""Where the port's entry points put their tensors.

Every public entry point takes ``device`` and defaults to the CUDA card.
Where torch has no CUDA device that default raises: nothing drops silently
to the CPU. CPU callers, the tests among them, pass ``device="cpu"``.
"""
from __future__ import annotations

import torch

DEFAULT = torch.device("cuda")


def resolve(device=DEFAULT) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device where torch
    has none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU")
    return device
