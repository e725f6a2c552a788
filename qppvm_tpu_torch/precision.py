"""Matmul-precision policy (port of qppvm_tpu/precision.py).

The Newton-Schulz inverses and the ADMM/KKT applies of the solver go to NaN
when float32 matmuls run at reduced precision (the reference measured
prim_res=NaN on a humanoid tick at bf16-input precision). On NVIDIA cards
the reduced format is TF32, which cuBLAS and cuDNN may use for float32
inputs, so the port turns it off everywhere and keeps full float32.
"""
from __future__ import annotations

import torch


def pin_f32_matmuls() -> None:
    """Run every float32 matmul and convolution in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
