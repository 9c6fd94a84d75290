"""BLAS-1 ops (the port of ``sparsh_amg_tpu/ops/blas.py``)."""
from __future__ import annotations

import torch


def dot(x: torch.Tensor, y: torch.Tensor,
        compensated: bool = True) -> torch.Tensor:
    """Inner product of fp32 vectors, as a 0-d tensor of x's dtype.  With
    `compensated`, fp32 inputs are accumulated in fp64 (the card has native
    fp64; the JAX package emulates it with df64 pairs)."""
    if compensated and x.dtype == torch.float32:
        return torch.dot(x.double(), y.double()).to(x.dtype)
    return torch.dot(x, y)


def norm_sq(x: torch.Tensor, compensated: bool = True) -> torch.Tensor:
    return dot(x, x, compensated)
