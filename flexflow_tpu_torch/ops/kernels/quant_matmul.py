"""INT8 / INT4 weight-only fused dequant + matmul (port of
``flexflow_tpu/ops/pallas/quant_matmul.py``; kernel ``csrc/quant_matmul.cu``).

``qmm_int8`` computes ``x @ w`` with ``w = round_to_x_dtype(q * scale)``;
``qmm_int4`` the same for the planar INT4 carrier with
``w = round_to_x_dtype(nibble * scale + offset)`` (multiply and add each
rounded in f32, no fused multiply-add). Both accumulate in f32 and give an
output in x's dtype or f32. A stacked ``[L, ...]`` carrier is addressed by a
layer index: the kernel offsets into the stacked buffer, so no layer is
copied out (the GPU form of ``quant_matmul_indexed``); a MoE expert stack
``[L, E, ...]`` by a layer and an expert index, at the flat index
``l * E + e``. There is no
eligibility gate: the kernel takes every shape. Each row's result is bitwise
independent of the row count of the call.

With bf16 x the kernel has regimes by row count (:func:`regime`): ``decode``
(M <= 16) and ``verify`` (M <= 128) stream each column slab's weights once
through a fused dequant + tensor-core kernel; ``tiled`` (up to
``PREFILL_ROWS``) is that kernel over 128x128 tiles; ``two-pass`` (from
``PREFILL_ROWS`` rows) dequantizes the carrier once into a bf16 [D, Fp]
scratch that the wrapper allocates, then runs a bf16 GEMM pass. All of them
sum each output element in the same order, so the regime never changes a
bit. One call counts one launch whatever the regime.

Under a gradient (``x.requires_grad``) ``quant_matmul`` goes through
``QuantMatmulFn``: its forward is the same launch (on the CPU the plain
version), its backward ``dx = dy @ dequant(W)^T`` in x's dtype, one carrier
(one layer's slice) dequantized at a time by the plain dequant and
multiplied with ``torch.matmul``. The carriers get no gradient. JAX has no
backward kernel here: its gradient is XLA's transpose of the dequant-dot.
A raw kernel launch writes into a fresh tensor with no ``grad_fn``, so
without the Function a gradient would skip every quantized projection on
the card while the CPU's plain version carried it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from flexflow_tpu_torch.ops.kernels import _build
from flexflow_tpu_torch.quant.weight_only import QuantizedArray

LAUNCHES = 0  # qmm_int8 kernel launches of this process (plain-version calls not counted)
LAUNCHES_INT4 = 0  # qmm_int4 kernel launches
BACKWARD_CALLS = 0  # QuantMatmulFn backward passes (dequant + torch.matmul; no kernel of ours)
PREFILL_ROWS = 192  # bf16 calls with at least this many rows take the two-pass prefill


def regime(m: int, d: int, fp: int, bits: int, x_bf16: bool = True,
           aligned: bool = True) -> str:
    """The kernel regime a call of ``m`` rows takes on carrier ``d`` x ``fp``
    (``aligned``: every pointer 16-byte aligned). Unaligned rows are filled
    with plain loads, in the decode tiling up to 16 rows and the 128x128 one
    above."""
    if not x_bf16:
        return "f32-fma"
    vec = aligned and (d // (2 if bits == 4 else 1)) % 8 == 0 and fp % 16 == 0
    if not vec:
        return "plain-loads-16" if m <= 16 else "plain-loads-128"
    if m <= 16:
        return "decode"
    if m <= 128:
        return "verify"
    return "two-pass" if m >= PREFILL_ROWS else "tiled"


def _scratch(x: torch.Tensor, d: int, fp: int, bits: int, *carrier) -> Optional[torch.Tensor]:
    """The two-pass prefill's bf16 [D, Fp] scratch, or None for the other
    regimes (the kernel allocates nothing). A layer of a stacked carrier is
    as aligned as the carrier when Fp % 16 == 0, which every aligned regime
    needs."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *carrier))
    if regime(x.shape[0], d, fp, bits, x.dtype == torch.bfloat16, aligned) != "two-pass":
        return None
    return torch.empty((d, fp), dtype=torch.bfloat16, device=x.device)


def qmm_int8_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   group_size: int, n_out: int, out_dtype) -> torch.Tensor:
    """Plain PyTorch version: x [M, D], q [D, Fp] int8, scale [D/g, Fp] f32."""
    w = dequant_weight(q, scale, None, 8, group_size, n_out, None, x.dtype)
    return torch.matmul(x.float(), w.float()).to(out_dtype)


def int4_weight(q: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
                group_size: int) -> torch.Tensor:
    """The f32 dequantized [D, Fp] weight of a planar INT4 carrier (q
    [D/2, Fp] uint8): low nibbles (unsigned) are rows [0, D/2), high nibbles
    (signed) rows [D/2, D); ``nibble * scale`` and ``+ offset`` round apart."""
    packed = q.view(torch.int8)
    qv = torch.cat([(packed & 0x0F).float(), (packed >> 4).float()], dim=0)
    s = torch.repeat_interleave(scale, group_size, dim=0)
    o = torch.repeat_interleave(offset, group_size, dim=0)
    return qv * s + o


def dequant_weight(q, scale, offset, bits: int, group_size: int, n_out: int,
                   index: Optional[int], dtype) -> torch.Tensor:
    """The [D, n_out] weight of one carrier (layer ``index`` of a stacked
    one) as the kernels use it: dequantized in f32, rounded to ``dtype``."""
    if index is not None:
        q, scale = q[index], scale[index]
        offset = None if offset is None else offset[index]
    if bits == 8:
        w = q.float() * torch.repeat_interleave(scale, group_size, dim=0)
    else:
        w = int4_weight(q, scale, offset, group_size)
    return w[:, :n_out].to(dtype)


def qmm_int4_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   offset: torch.Tensor, group_size: int, n_out: int,
                   out_dtype) -> torch.Tensor:
    """Plain PyTorch version: x [M, D], q [D/2, Fp] uint8, scale and offset
    [D/g, Fp] f32."""
    w = dequant_weight(q, scale, offset, 4, group_size, n_out, None, x.dtype)
    return torch.matmul(x.float(), w.float()).to(out_dtype)


def _check(name, x, q, scale, offset, pack, group_size, n_out, layer, out_dtype):
    """Shared argument checks; returns (D, Fp)."""
    stacked = layer is not None
    tables = [scale] + ([offset] if offset is not None else [])
    if q.dim() != (3 if stacked else 2) or any(t.dim() != q.dim() for t in tables):
        raise ValueError(f"{name}: carrier rank {q.dim()} does not match layer={layer}")
    d, fp = pack * q.shape[-2], q.shape[-1]
    if x.dim() != 2 or x.shape[1] != d:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not contract with q {tuple(q.shape)}")
    if d % group_size or any(t.shape[-2:] != (d // group_size, fp) for t in tables):
        raise ValueError(f"{name}: scale/offset shape does not match the carrier")
    if not 0 < n_out <= fp:
        raise ValueError(f"{name}: n_out {n_out} outside (0, {fp}]")
    if x.device.type == "cpu":
        return d, fp
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {x.device}")
    if any(t.device != x.device for t in (q, *tables)):
        raise ValueError(f"{name}: x, q, scale and offset must be on one device")
    if any(t.dtype != torch.float32 for t in tables):
        raise TypeError(f"{name}: scale and offset must be float32")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: x must be bfloat16 or float32, got {x.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"{name}: out_dtype must be {x.dtype} or float32, got {out_dtype}")
    if not all(t.is_contiguous() for t in (x, q, *tables)):
        raise ValueError(f"{name} needs contiguous x, q, scale and offset")
    if stacked and not 0 <= layer < q.shape[0]:
        raise IndexError(f"{name}: layer {layer} outside [0, {q.shape[0]})")
    return d, fp


def qmm_int8(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
             group_size: int, n_out: int, layer: Optional[int] = None,
             out_dtype=None) -> torch.Tensor:
    """x [M, D] @ dequant(q[layer]) -> [M, n_out] in ``out_dtype`` (default
    x's dtype; float32 is the other choice). ``q`` is [D, Fp] or, with
    ``layer``, a stacked [L, D, Fp]; ``scale`` matches with D/g rows."""
    global LAUNCHES
    out_dtype = out_dtype or x.dtype
    d, fp = _check("qmm_int8", x, q, scale, None, 1, group_size, n_out, layer, out_dtype)
    if x.device.type == "cpu":
        ql = q[layer] if layer is not None else q
        sl = scale[layer] if layer is not None else scale
        return qmm_int8_plain(x, ql, sl, group_size, n_out, out_dtype)
    if q.dtype != torch.int8:
        raise TypeError(f"qmm_int8: q must be int8, got {q.dtype}")
    out = torch.empty((x.shape[0], n_out), dtype=out_dtype, device=x.device)
    if x.shape[0] == 0:
        return out
    scratch = _scratch(x, d, fp, 8, q, scale)
    err = _build.lib().ff_qmm_int8(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), x.shape[0], d, fp, n_out, group_size,
        int(layer or 0),
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.float32),
        _build.stream_ptr(x.device),
    )
    _build.check(err, "qmm_int8")
    LAUNCHES += 1
    return out


def qmm_int4(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor, *,
             group_size: int, n_out: int, layer: Optional[int] = None,
             out_dtype=None) -> torch.Tensor:
    """x [M, D] @ dequant(q[layer]) -> [M, n_out] for the planar INT4
    carrier: ``q`` [D/2, Fp] uint8 (or a stacked [L, D/2, Fp] with
    ``layer``), ``scale`` and ``offset`` [(L,) D/g, Fp] f32."""
    global LAUNCHES_INT4
    out_dtype = out_dtype or x.dtype
    d, fp = _check("qmm_int4", x, q, scale, offset, 2, group_size, n_out, layer, out_dtype)
    if x.device.type == "cpu":
        pick = (lambda t: t[layer]) if layer is not None else (lambda t: t)
        return qmm_int4_plain(x, pick(q), pick(scale), pick(offset), group_size, n_out,
                              out_dtype)
    if q.dtype != torch.uint8:
        raise TypeError(f"qmm_int4: q must be uint8, got {q.dtype}")
    out = torch.empty((x.shape[0], n_out), dtype=out_dtype, device=x.device)
    if x.shape[0] == 0:
        return out
    scratch = _scratch(x, d, fp, 4, q, scale, offset)
    err = _build.lib().ff_qmm_int4(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), offset.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), x.shape[0], d, fp, n_out, group_size,
        int(layer or 0),
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.float32),
        _build.stream_ptr(x.device),
    )
    _build.check(err, "qmm_int4")
    LAUNCHES_INT4 += 1
    return out


@dataclasses.dataclass
class LayerQuant:
    """Layer ``layer`` of a stacked [L, ...] QuantizedArray (of a [L, E, ...]
    expert stack, the layer's [E, ...] experts): the kernel reads it straight
    from the stacked buffer."""

    qa: QuantizedArray
    layer: int


def _operands(x: torch.Tensor, qa: QuantizedArray, layer: Optional[int],
              expert: Optional[int]):
    """(x as [M, D], q, scale, offset, index, out shape): an expert stack
    ``[L, E, ...]`` is addressed as its ``[L*E, ...]`` view at the flat index
    ``layer * E + expert`` (no copy)."""
    cdims = qa.contract_dims
    bd = (layer is not None) + (expert is not None)
    if qa.q.dim() - 2 != bd:
        raise ValueError(f"carrier has {qa.q.dim() - 2} batch dims, expected {bd}")
    q, scale, offset, index = qa.q, qa.scale, qa.offset, layer
    if expert is not None:
        if layer is None:
            raise ValueError("an expert index needs a layer index")
        n_exp = q.shape[1]
        if not 0 <= expert < n_exp:
            raise IndexError(f"expert {expert} outside [0, {n_exp})")

        def flat(t):  # a view: a copy of a [L, E, ...] stack would be gigabytes
            return None if t is None else t.view(-1, *t.shape[2:])

        q, scale, offset, index = flat(q), flat(scale), flat(offset), layer * n_exp + expert
    unit = qa.shape[qa.batch_dims:]
    lead = x.shape[: x.dim() - cdims]
    xb = x.reshape(math.prod(lead), qa.d_contract).contiguous()
    return xb, q, scale, offset, index, (*lead, *unit[cdims:])


def _launch(xb, q, scale, offset, bits, group_size, n_out, index, out_dtype):
    kw = dict(group_size=group_size, n_out=n_out, layer=index, out_dtype=out_dtype)
    if bits == 8:
        return qmm_int8(xb, q, scale, **kw)
    if bits == 4:
        return qmm_int4(xb, q, scale, offset, **kw)
    raise ValueError(f"no quant-matmul for {bits}-bit carriers")


class QuantMatmulFn(torch.autograd.Function):
    """``x @ dequant(W)`` with a gradient for x (see the module docstring)."""

    @staticmethod
    def forward(ctx, xb, q, scale, offset, bits, group_size, n_out, index, out_dtype):
        ctx.save_for_backward(q, scale, offset)
        ctx.meta = (bits, group_size, n_out, index, xb.dtype)
        return _launch(xb, q, scale, offset, bits, group_size, n_out, index, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        global BACKWARD_CALLS
        q, scale, offset = ctx.saved_tensors
        bits, group_size, n_out, index, x_dtype = ctx.meta
        w = dequant_weight(q, scale, offset, bits, group_size, n_out, index, x_dtype)
        BACKWARD_CALLS += 1
        return (torch.matmul(dy.to(x_dtype), w.t()),) + (None,) * 8


def quant_matmul(x: torch.Tensor, qa: QuantizedArray, *, layer: Optional[int] = None,
                 expert: Optional[int] = None, out_dtype=None) -> torch.Tensor:
    """x @ dequantize(qa) (or of layer ``layer`` of a stacked carrier, and of
    expert ``expert`` of that layer in a ``[L, E, D, Fp]`` expert stack).

    The contraction axes of ``x`` are its last ``qa.contract_dims`` axes; the
    output gets the unit's out shape. INT8 goes through ``qmm_int8``, INT4
    through ``qmm_int4``; under a gradient both through ``QuantMatmulFn``.
    """
    xb, q, scale, offset, index, out_shape = _operands(x, qa, layer, expert)
    args = (q, scale, offset, qa.bits, qa.group_size, qa.d_rest, index, out_dtype or x.dtype)
    if torch.is_grad_enabled() and xb.requires_grad:
        out = QuantMatmulFn.apply(xb, *args)
    else:
        out = _launch(xb, *args)
    return out.reshape(out_shape)


def quant_matmul_plain(x: torch.Tensor, qa: QuantizedArray, *, layer: Optional[int] = None,
                       expert: Optional[int] = None, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul` on any device (autograd
    runs through its torch ops): the yardstick of the kernels and of
    ``QuantMatmulFn``'s backward."""
    xb, q, scale, offset, index, out_shape = _operands(x, qa, layer, expert)
    w = dequant_weight(q, scale, offset, qa.bits, qa.group_size, qa.d_rest, index, x.dtype)
    out = torch.matmul(xb.float(), w.float()).to(out_dtype or x.dtype)
    return out.reshape(out_shape)
