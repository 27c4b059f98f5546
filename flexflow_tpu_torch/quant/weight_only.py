"""Weight-only INT8/INT4 grouped quantization (port of
``flexflow_tpu/quant/weight_only.py``).

The carriers are byte-identical to the JAX package's, so a model quantized by
either package loads into the other unchanged:

- INT8: symmetric. ``q`` [*B, D, R] int8, ``scale`` [*B, D/g, R] f32,
  ``q = clip(round_half_even(w / scale), -127, 127)``.
- INT4: asymmetric, planar. ``q`` [*B, D/2, R] uint8: byte r packs element r
  (low nibble, unsigned [0, 15]) and element r + D/2 (high nibble, signed,
  stored as ``(value + 8) ^ 8``). ``offset`` holds the group minimum; for the
  high-half groups it is pre-biased by ``+ 8 * scale``.
- ``rest_pad``: the out dim is zero-padded to a multiple of 512 when
  d >= 1024 and R >= 512 (the JAX kernel's block width; kept for identity).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class QuantizedArray:
    """Grouped weight-only quantized tensor (see the module docstring)."""

    q: torch.Tensor
    scale: torch.Tensor
    offset: Optional[torch.Tensor]
    bits: int
    group_size: int
    shape: Tuple[int, ...]
    batch_dims: int
    contract_dims: int
    dtype: Any  # torch dtype of the dequantized weight
    rest_pad: int = 0

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def unit_shape(self) -> Tuple[int, ...]:
        return self.shape[self.batch_dims:]

    @property
    def d_contract(self) -> int:
        return math.prod(self.unit_shape[: self.contract_dims])

    @property
    def d_rest(self) -> int:
        return math.prod(self.unit_shape[self.contract_dims:])

    def to(self, device) -> "QuantizedArray":
        return dataclasses.replace(
            self,
            q=self.q.to(device),
            scale=self.scale.to(device),
            offset=None if self.offset is None else self.offset.to(device),
        )


def _pick_group_size(d: int, group_size: int, bits: int) -> int:
    # INT4 planar packing: groups must not straddle the half-plane boundary
    span = d // 2 if bits == 4 else d
    g = min(group_size, span)
    while span % g:
        g //= 2
    return max(g, 1)


def _rest_pad(d: int, rest: int) -> int:
    return (-rest) % 512 if (d >= 1024 and rest >= 512) else 0


def quantize(
    w: torch.Tensor,
    bits: int = 8,
    group_size: int = 128,
    *,
    batch_dims: int = 0,
    contract_dims: int = 1,
    compute_dtype=torch.bfloat16,
) -> QuantizedArray:
    """Quantize ``w`` along its (flattened) contraction axes with per-group
    scale/offset; leading ``batch_dims`` axes are quantized independently."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    shape = tuple(w.shape)
    unit = shape[batch_dims:]
    d = int(np.prod(unit[:contract_dims]))
    rest = int(np.prod(unit[contract_dims:])) if unit[contract_dims:] else 1
    if bits == 4 and d % 2:
        raise ValueError(f"INT4 needs even contraction dim, got {d}")
    g = _pick_group_size(d, group_size, bits)
    b = int(np.prod(shape[:batch_dims])) if batch_dims else 1

    # divisors are full tensors: a Python-scalar divisor may be turned into a
    # multiply by its reciprocal, which is not the division JAX rounds
    wf = w.to(torch.float32).reshape(b, d // g, g, rest)
    rest_pad = _rest_pad(d, rest)
    if rest_pad:
        wf = torch.nn.functional.pad(wf, (0, rest_pad))
    restp = rest + rest_pad

    if bits == 8:
        amax = torch.amax(torch.abs(wf), dim=2, keepdim=True)
        scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
        q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        q = q.reshape(shape[:batch_dims] + (d, restp))
        scale = scale[:, :, 0].reshape(shape[:batch_dims] + (d // g, restp))
        offset = None
    else:
        lo = torch.amin(wf, dim=2, keepdim=True)
        hi = torch.amax(wf, dim=2, keepdim=True)
        scale = torch.clamp_min((hi - lo) / torch.full_like(hi, 15.0), 1e-12)
        qv = torch.clamp(torch.round((wf - lo) / scale), 0, 15).to(torch.uint8)
        qv = qv.reshape(b, d, restp)
        half = d // 2
        q = qv[:, :half] | ((qv[:, half:] ^ 8) << 4)
        q = q.reshape(shape[:batch_dims] + (d // 2, restp))
        offset = lo[:, :, 0].clone()
        scale = scale[:, :, 0]
        gh = (d // g) // 2
        offset[:, gh:] += 8.0 * scale[:, gh:]
        offset = offset.reshape(shape[:batch_dims] + (d // g, restp))
        scale = scale.reshape(shape[:batch_dims] + (d // g, restp))

    return QuantizedArray(
        q=q.contiguous(), scale=scale.contiguous(),
        offset=None if offset is None else offset.contiguous(),
        bits=bits, group_size=g, shape=shape, batch_dims=batch_dims,
        contract_dims=contract_dims, dtype=compute_dtype, rest_pad=rest_pad,
    )


def dequantize(qa: QuantizedArray) -> torch.Tensor:
    """Full reconstruction in ``qa.dtype``: exact in float32, rounded once.

    Leading batch axes may already be indexed away (a per-layer view of a
    stacked carrier): effective batch dims come from ``q.ndim``.
    """
    d, rest, g = qa.d_contract, qa.d_rest, qa.group_size
    restp = rest + qa.rest_pad
    eff_bd = qa.q.ndim - 2
    out_shape = qa.shape[qa.batch_dims - eff_bd:]
    bshape = out_shape[:eff_bd]
    b = int(np.prod(bshape)) if bshape else 1

    if qa.bits == 8:
        q = qa.q.reshape(b, d // g, g, restp).to(torch.float32)
        w = q * qa.scale.reshape(b, d // g, 1, restp)
    else:
        packed = qa.q.reshape(b, d // 2, restp).view(torch.int8)
        lo = (packed & 0xF).to(torch.float32)
        hi = (packed >> 4).to(torch.float32)  # arithmetic shift: signed
        qv = torch.cat([lo, hi], dim=1)
        scale = qa.scale.reshape(b, d // g, 1, restp)
        off = qa.offset.reshape(b, d // g, 1, restp)
        w = qv.reshape(b, d // g, g, restp) * scale + off
    w = w.reshape(b, d, restp)[:, :, :rest]
    return w.reshape(out_shape).to(qa.dtype)


def concat_rest(qas, unit_rest_shape) -> QuantizedArray:
    """Concatenate QuantizedArrays along the (flattened) output axis — exact,
    column-wise, no repacking (builds the fused wqkv / wgu carriers)."""
    q0 = qas[0]
    for qa in qas[1:]:
        if (qa.bits, qa.group_size, qa.batch_dims, qa.contract_dims, qa.dtype,
                qa.d_contract) != (q0.bits, q0.group_size, q0.batch_dims,
                                   q0.contract_dims, q0.dtype, q0.d_contract):
            raise ValueError("incompatible quantization configs")
    rest = sum(qa.d_rest for qa in qas)
    if rest != int(np.prod(unit_rest_shape)):
        raise ValueError(f"fused width {rest} != {unit_rest_shape}")

    def cat(field):
        return torch.cat([getattr(qa, field)[..., : qa.d_rest] for qa in qas], dim=-1)

    d = q0.d_contract
    rest_pad = _rest_pad(d, rest)
    q, scale = cat("q"), cat("scale")
    offset = cat("offset") if q0.offset is not None else None
    if rest_pad:
        pad = (0, rest_pad)
        q = torch.nn.functional.pad(q, pad)
        scale = torch.nn.functional.pad(scale, pad)
        offset = torch.nn.functional.pad(offset, pad) if offset is not None else None
    shape = (q0.shape[: q0.batch_dims]
             + q0.unit_shape[: q0.contract_dims] + tuple(unit_rest_shape))
    return QuantizedArray(
        q=q.contiguous(), scale=scale.contiguous(),
        offset=None if offset is None else offset.contiguous(), bits=q0.bits,
        group_size=q0.group_size, shape=shape, batch_dims=q0.batch_dims,
        contract_dims=q0.contract_dims, dtype=q0.dtype, rest_pad=rest_pad,
    )


def as_array(w) -> torch.Tensor:
    """Materialize quantized weights; pass plain tensors through."""
    if isinstance(w, QuantizedArray):
        return dequantize(w)
    return w


_QUANT_2D = {"wg", "wu", "wd"}  # per-layer [L, D, F], or [L, E, D, F] experts
_QUANT_HEADS = {"wq", "wk", "wv"}  # per-layer [L, D, H, Dh] (contract D)


def layer_quant_layout(name: str, ndim: int) -> Optional[Tuple[int, int]]:
    """(batch_dims, contract_dims) with which ``quantize_params`` quantizes
    the stacked layer leaf ``name`` of ``ndim`` dims, or None if it stays
    full precision."""
    if name in _QUANT_HEADS:
        return 1, 1
    if name == "wo":
        return 1, 2
    if name in _QUANT_2D:
        return ndim - 2, 1
    return None


def quantize_params(spec, params, bits: int = 8, group_size: int = 128,
                    compute_dtype=torch.bfloat16):
    """Quantize every matmul weight of a decoder params dict: the lm_head and
    the per-layer projections (norms, embeddings and a MoE router stay full
    precision)."""
    del spec
    out = dict(params)
    if "lm_head" in params:
        out["lm_head"] = quantize(params["lm_head"], bits, group_size,
                                  compute_dtype=compute_dtype)
    layers = dict(params["layers"])
    for name, leaf in params["layers"].items():
        layout = layer_quant_layout(name, leaf.ndim)
        if layout is not None:
            layers[name] = quantize(leaf, bits, group_size, batch_dims=layout[0],
                                    contract_dims=layout[1], compute_dtype=compute_dtype)
    out["layers"] = layers
    return out
