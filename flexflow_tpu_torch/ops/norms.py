"""Normalization ops (port of ``flexflow_tpu/ops/norms.py``).

Plain PyTorch: norms accumulate in float32 and cast back to the input dtype,
as the JAX versions do. A row's mean (``row_mean``) does not depend on how
many rows the call carries, so a token verified in a speculative tree is
normalized as its incremental decode step was.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

ROW_BLOCK = 128  # rows of one row-mean GEMM


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the last dim of float32 ``x`` [..., D], as [..., 1]. The
    card's reduction kernel splits a row's sum by the number of rows, so
    there it is a product with a ones column in GEMMs of ``ROW_BLOCK`` rows,
    the last zero-padded; the CPU's reduction keeps each row's order."""
    if x.device.type != "cuda":
        return torch.mean(x, dim=-1, keepdim=True)
    d = x.shape[-1]
    flat = x.reshape(-1, d)
    n = flat.shape[0]
    pad = -n % ROW_BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, d))])
    ones = torch.ones((d, 1), dtype=x.dtype, device=x.device)
    sums = torch.cat([block @ ones for block in flat.split(ROW_BLOCK)])[:n]
    return (sums / d).reshape(*x.shape[:-1], 1)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = row_mean(xf * xf)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * scale.float()).to(dtype)


def layer_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    eps: float,
) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mean = row_mean(xf)
    var = row_mean(torch.square(xf - mean))
    y = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def residual_rms_norm(x: torch.Tensor, residual: torch.Tensor, scale: torch.Tensor,
                      eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual add then RMSNorm; returns (residual_out, normed)."""
    res = x + residual
    return res, rms_norm(res, scale, eps)


def residual_layer_norm(x: torch.Tensor, residual: torch.Tensor, scale: torch.Tensor,
                        bias: Optional[torch.Tensor],
                        eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual add then LayerNorm; returns (residual_out, normed)."""
    res = x + residual
    return res, layer_norm(res, scale, bias, eps)
