"""Design variants of the fused dequant + matmul (port of the kernel bodies
of ``benchmarks/tune_int4_variants.py``; kernels ``csrc/qmm_variants.cu``).

Six ways to compute ``x @ dequantize(qa)`` at decode rows, which differ in
how the nibbles are unpacked and in how many tensor-core dots a group takes:

- ``i8_group``: INT8 -> bf16 exactly, one dot per group, the scale applied
  after the dot in f32.
- ``i4_floor``: nibbles by ``hi = floor(v/16)``, ``lo = v - 16 hi``; per-group
  dots; the offset enters through the group's x sums.
- ``i4_3dot``: as ``i4_floor`` with ``dot(x_lo, lo) = dot(x_lo, v) -
  16 dot(x_lo, hi)``: ``lo`` is never formed.
- ``i4_and``: nibbles by two ANDs (``v & 0x0F``, ``v & 0xF0`` = 16 hi); the
  /16 folds into the high half's scale after the dot.
- ``i4_and_bigdot``: AND unpack, full dequant to bf16, one dot over D.
- ``i4_and_2dot``: as ``i4_and_bigdot`` with one accumulator per planar half.

``v`` is the packed carrier read as int8, ``x_lo`` / ``x_hi`` the first and
second halves of x's columns (the planar INT4 rows). Every multiply and add
after a dot rounds apart, in the plain versions as in the kernels, so a
one-hot row of x returns the dequantized weight's row bitwise. Inputs are the
port's carriers (``quant.weight_only.QuantizedArray``): INT8 ``q`` [D, Fp]
with ``scale`` [D/g, Fp], or INT4 planar ``q`` [D/2, Fp] uint8 with
``scale`` and ``offset`` [D/g, Fp] (g | D/2), all f32; the output is
[B, n_out] in x's dtype. ``cols`` is the kernel's output columns per block.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ops.kernels import _build

VARIANTS = ("i8_group", "i4_floor", "i4_3dot", "i4_and", "i4_and_bigdot", "i4_and_2dot")
# kernel launches of this process per variant (plain-version calls not counted)
LAUNCHES = {name: 0 for name in VARIANTS}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _grouped(xh: torch.Tensor, group_size: int) -> torch.Tensor:
    """x columns [B, K] as f32 groups [K/g, B, g]."""
    b, k = xh.shape
    return xh.float().reshape(b, k // group_size, group_size).transpose(0, 1)


def _gdot(xg: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-group f32 dots: xg [G, B, g] with w [G*g, n] -> [G, B, n]."""
    gg, _, g = xg.shape
    return torch.bmm(xg, w.reshape(gg, g, -1))


def _nibbles(q: torch.Tensor, n_out: int):
    """The packed INT4 bytes as int8 [D/2, n_out]."""
    return q.view(torch.int8)[:, :n_out]


def _post(plo, phi, xl, xh, scale, offset, n_out, s_hi_mult=None):
    """sum over groups of dot_lo s_lo + xsum_lo off_lo + dot_hi s_hi +
    xsum_hi off_hi, each multiply and add rounded apart."""
    gh = scale.shape[0] // 2
    s_lo, s_hi = scale[:gh, None, :n_out], scale[gh:, None, :n_out]
    o_lo, o_hi = offset[:gh, None, :n_out], offset[gh:, None, :n_out]
    if s_hi_mult is not None:
        s_hi = s_hi * s_hi_mult
    xs_l = xl.sum(2)[:, :, None]
    xs_h = xh.sum(2)[:, :, None]
    return ((plo * s_lo + xs_l * o_lo) + (phi * s_hi + xs_h * o_hi)).sum(0)


def i8_group_plain(x, q, scale, group_size: int, n_out: int) -> torch.Tensor:
    """Plain PyTorch version of ``i8_group``: x [B, D], q [D, Fp] int8,
    scale [D/g, Fp] f32."""
    pg = _gdot(_grouped(x, group_size), q[:, :n_out].float())
    return (pg * scale[:, None, :n_out]).sum(0).to(x.dtype)


def i4_floor_plain(x, q, scale, offset, group_size: int, n_out: int) -> torch.Tensor:
    """Plain PyTorch version of ``i4_floor`` (planar INT4 carrier)."""
    d2 = q.shape[0]
    v = _nibbles(q, n_out).float()
    hi = torch.floor(v * 0.0625)
    lo = v - 16.0 * hi
    xl, xh = _grouped(x[:, :d2], group_size), _grouped(x[:, d2:], group_size)
    out = _post(_gdot(xl, lo), _gdot(xh, hi), xl, xh, scale, offset, n_out)
    return out.to(x.dtype)


def i4_3dot_plain(x, q, scale, offset, group_size: int, n_out: int) -> torch.Tensor:
    """Plain PyTorch version of ``i4_3dot`` (planar INT4 carrier)."""
    d2 = q.shape[0]
    v = _nibbles(q, n_out).float()
    hi = torch.floor(v * 0.0625)
    xl, xh = _grouped(x[:, :d2], group_size), _grouped(x[:, d2:], group_size)
    plo = _gdot(xl, v) - 16.0 * _gdot(xl, hi)
    out = _post(plo, _gdot(xh, hi), xl, xh, scale, offset, n_out)
    return out.to(x.dtype)


def i4_and_plain(x, q, scale, offset, group_size: int, n_out: int) -> torch.Tensor:
    """Plain PyTorch version of ``i4_and`` (planar INT4 carrier)."""
    d2 = q.shape[0]
    v = _nibbles(q, n_out)
    lo, hi16 = (v & 0x0F).float(), (v & -16).float()
    xl, xh = _grouped(x[:, :d2], group_size), _grouped(x[:, d2:], group_size)
    out = _post(_gdot(xl, lo), _gdot(xh, hi16), xl, xh, scale, offset, n_out, 0.0625)
    return out.to(x.dtype)


def _and_weights(q, scale, offset, group_size: int, n_out: int, dtype):
    """The AND-unpacked, dequantized halves [D/2, n_out], rounded to dtype."""
    gh = scale.shape[0] // 2
    v = _nibbles(q, n_out)
    lo, hi16 = (v & 0x0F).float(), (v & -16).float()

    def rep(t):
        return torch.repeat_interleave(t[:, :n_out], group_size, dim=0)

    w_lo = lo * rep(scale[:gh]) + rep(offset[:gh])
    w_hi = hi16 * rep(scale[gh:] * 0.0625) + rep(offset[gh:])
    return w_lo.to(dtype), w_hi.to(dtype)


def i4_and_bigdot_plain(x, q, scale, offset, group_size: int, n_out: int) -> torch.Tensor:
    """Plain PyTorch version of ``i4_and_bigdot`` (planar INT4 carrier)."""
    w_lo, w_hi = _and_weights(q, scale, offset, group_size, n_out, x.dtype)
    w = torch.cat([w_lo, w_hi], dim=0)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def i4_and_2dot_plain(x, q, scale, offset, group_size: int, n_out: int) -> torch.Tensor:
    """Plain PyTorch version of ``i4_and_2dot`` (planar INT4 carrier)."""
    d2 = q.shape[0]
    w_lo, w_hi = _and_weights(q, scale, offset, group_size, n_out, x.dtype)
    acc = torch.matmul(x[:, :d2].float(), w_lo.float())
    acc = acc + torch.matmul(x[:, d2:].float(), w_hi.float())
    return acc.to(x.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(name, x, q, tables, group_size, n_out, cols):
    """Argument checks shared by the wrappers; returns (D, Fp)."""
    int4 = len(tables) == 2
    if x.dim() != 2 or q.dim() != 2 or any(t.dim() != 2 for t in tables):
        raise ValueError(f"{name}: x, q, scale and offset must be 2-D")
    d, fp = (2 if int4 else 1) * q.shape[0], q.shape[1]
    if x.shape[1] != d:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not contract with q {tuple(q.shape)}")
    span = d // 2 if int4 else d
    if group_size <= 0 or span % group_size:
        raise ValueError(f"{name}: group size {group_size} does not divide "
                         f"{'D/2' if int4 else 'D'} = {span}")
    if any(tuple(t.shape) != (d // group_size, fp) for t in tables):
        raise ValueError(f"{name}: scale/offset shape does not match the carrier")
    if not 0 < n_out <= fp:
        raise ValueError(f"{name}: n_out {n_out} outside (0, {fp}]")
    if cols % 16 or not 16 <= cols <= 128:
        raise ValueError(f"{name}: cols {cols} is not a multiple of 16 in [16, 128]")
    if x.device.type == "cpu":
        return d, fp
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {x.device}")
    if any(t.device != x.device for t in (q, *tables)):
        raise ValueError(f"{name}: x, q, scale and offset must be on one device")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x must be bfloat16, got {x.dtype}")
    if q.dtype != (torch.uint8 if int4 else torch.int8):
        raise TypeError(f"{name}: q must be {'uint8' if int4 else 'int8'}, got {q.dtype}")
    if any(t.dtype != torch.float32 for t in tables):
        raise TypeError(f"{name}: scale and offset must be float32")
    if not all(t.is_contiguous() for t in (x, q, *tables)):
        raise ValueError(f"{name} needs contiguous x, q, scale and offset")
    return d, fp


def _run(name, plain, x, q, tables, group_size, n_out, cols):
    d, fp = _check(name, x, q, tables, group_size, n_out, cols)
    if x.device.type == "cpu":
        return plain(x, q, *tables, group_size, n_out)
    out = torch.empty((x.shape[0], n_out), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return out
    err = getattr(_build.lib(), f"ff_qmm_v_{name}")(
        x.data_ptr(), q.data_ptr(), *[t.data_ptr() for t in tables], out.data_ptr(),
        x.shape[0], d, fp, n_out, group_size, cols, _build.stream_ptr(x.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out


def i8_group(x, q, scale, *, group_size: int, n_out: int, cols: int = 32) -> torch.Tensor:
    """x [B, D] @ dequant(q) -> [B, n_out] for an INT8 carrier, the scale
    applied after each group's dot."""
    return _run("i8_group", i8_group_plain, x, q, [scale], group_size, n_out, cols)


def i4_floor(x, q, scale, offset, *, group_size: int, n_out: int, cols: int = 32):
    """x [B, D] @ dequant(q) -> [B, n_out], nibbles unpacked by floor."""
    return _run("i4_floor", i4_floor_plain, x, q, [scale, offset], group_size, n_out, cols)


def i4_3dot(x, q, scale, offset, *, group_size: int, n_out: int, cols: int = 32):
    """x [B, D] @ dequant(q) -> [B, n_out], three dots per group pair."""
    return _run("i4_3dot", i4_3dot_plain, x, q, [scale, offset], group_size, n_out, cols)


def i4_and(x, q, scale, offset, *, group_size: int, n_out: int, cols: int = 32):
    """x [B, D] @ dequant(q) -> [B, n_out], nibbles unpacked by two ANDs."""
    return _run("i4_and", i4_and_plain, x, q, [scale, offset], group_size, n_out, cols)


def i4_and_bigdot(x, q, scale, offset, *, group_size: int, n_out: int, cols: int = 32):
    """x [B, D] @ dequant(q) -> [B, n_out], full dequant and one dot over D."""
    return _run("i4_and_bigdot", i4_and_bigdot_plain, x, q, [scale, offset], group_size,
                n_out, cols)


def i4_and_2dot(x, q, scale, offset, *, group_size: int, n_out: int, cols: int = 32):
    """x [B, D] @ dequant(q) -> [B, n_out], full dequant, one dot per half."""
    return _run("i4_and_2dot", i4_and_2dot_plain, x, q, [scale, offset], group_size, n_out,
                cols)


def variant(name: str, x, qa, cols: int = 32) -> torch.Tensor:
    """Variant ``name`` on carrier ``qa`` (a ``QuantizedArray``, 2-D, with
    x's columns as its contraction): [B, qa.d_rest]."""
    tables = [qa.scale] if name == "i8_group" else [qa.scale, qa.offset]
    if (qa.bits == 8) != (name == "i8_group"):
        raise ValueError(f"{name} does not take a {qa.bits}-bit carrier")
    return globals()[name](x, qa.q, *tables, group_size=qa.group_size, n_out=qa.d_rest,
                           cols=cols)


def plain(name: str, x, qa) -> torch.Tensor:
    """The plain version of variant ``name`` on carrier ``qa``."""
    tables = [qa.scale] if name == "i8_group" else [qa.scale, qa.offset]
    return globals()[f"{name}_plain"](x, qa.q, *tables, qa.group_size, qa.d_rest)
