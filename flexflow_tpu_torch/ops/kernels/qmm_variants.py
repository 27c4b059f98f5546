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
[B, n_out] in x's dtype. ``cols`` is the kernel's column tile: a block's
columns in the other variants.

``i8_group`` and ``i4_and_2dot`` (``SPLIT_K``) hold several column tiles
side by side in a block and cut the contraction across blocks in whole
groups (group pairs for INT4): :func:`split_plan` chooses the blocks along
it from the shape and the SM count, and the wrapper hands the kernel a
workspace for the splits' partial sums and zeroed counters, which the
kernel leaves zeroed, with their sizes: the kernel's launcher works its
geometry out again and refuses buffers smaller than it indexes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from flexflow_tpu_torch.ops.kernels import _build

VARIANTS = ("i8_group", "i4_floor", "i4_3dot", "i4_and", "i4_and_bigdot", "i4_and_2dot")
SPLIT_K = ("i8_group", "i4_and_2dot")
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


# the split-K kernels' constants (csrc/qmm_variants.cu SK_ROWS, SK_STAGES,
# SK_WARPS, SK_SMEM)
_SK_ROWS, _SK_STAGES, _SK_WARPS, _SK_SMEM = 32, 4, 8, 232448
_INFLIGHT = 52 * 1024  # packed bytes in flight an SM


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """A split-K launch (``SplitGeom`` in csrc/qmm_variants.cu)."""

    splits: int  # blocks along the contraction (grid z)
    units: int  # groups (INT8) or group pairs (INT4) along D
    units_per_block: int  # every warp of a block walks them all
    warp_cols: int  # columns of a warp
    tiles_per_block: int  # column tiles of ``cols`` side by side in a block
    rows: int  # rows of x a block
    grid: tuple  # (column tiles / tiles_per_block, row tiles, splits)
    threads: int
    smem: int  # dynamic shared memory of a block, bytes
    ws_shape: Optional[tuple]  # f32 partial sums (None when splits == 1)
    tickets: int  # counters, one a block of a split (0 when splits == 1)


def _geometry(int4: bool, m: int, d: int, n_out: int, g: int, cols: int,
              splits: int) -> SplitPlan:
    units = d // (2 * g) if int4 else d // g
    ub = -(-units // splits)
    rows = 8 if m <= 8 else 16
    nsub = 1
    while nsub * 2 <= (2 if int4 else 4) // (rows // 8) and cols // 16 % (nsub * 2) == 0:
        nsub *= 2
    ncw = cols // (16 * nsub)
    tpb = max(1, _SK_WARPS // ncw)
    gp = -(-g // 32) * 32
    bw = ncw * tpb * 16 * nsub  # packed bytes of a row the block reads
    pitch = bw + (0 if bw // 16 % 2 else 16)
    stage = _SK_ROWS * pitch + (4 if int4 else 1) * bw * 4
    x_bytes = -(-(2 if int4 else 1) * rows * (ub * gp + 8) * 2 // 128) * 128
    smem = x_bytes + _SK_STAGES * stage
    threads = ncw * tpb * 32
    grid = (-(-(-(-n_out // cols)) // tpb), -(-m // rows), splits)
    vals = nsub * rows // 8 * (8 if int4 else 4)
    tiles = grid[0] * grid[1]
    return SplitPlan(splits, units, ub, 16 * nsub, tpb, rows, grid, threads, smem,
                     (splits, tiles, threads // 32, vals, 32) if splits > 1 else None,
                     tiles if splits > 1 else 0)


@functools.lru_cache(maxsize=256)
def split_candidates(name: str, m: int, d: int, n_out: int, group_size: int,
                     cols: int) -> tuple:
    """Every split-K launch of ``name`` (one of ``SPLIT_K``) for x [m, d] and
    ``n_out`` columns that leaves no block along D without a unit and fits a
    block's shared memory, by rising split."""
    int4 = name == "i4_and_2dot"
    units = d // (2 * group_size) if int4 else d // group_size
    plans = []
    for splits in range(1, units + 1):
        if -(-units // -(-units // splits)) != splits:
            continue  # the same blocks as fewer splits, one left empty
        p = _geometry(int4, m, d, n_out, group_size, cols, splits)
        if p.smem <= _SK_SMEM:
            plans.append(p)
    return tuple(plans)


@functools.lru_cache(maxsize=256)
def split_plan(name: str, m: int, d: int, n_out: int, group_size: int, cols: int,
               sms: int) -> SplitPlan:
    """The split-K launch of ``name`` (one of ``SPLIT_K``) for x [m, d] and
    ``n_out`` columns on a card of ``sms`` SMs. Of :func:`split_candidates`,
    the one whose block count is nearest to ``_INFLIGHT`` bytes of packed
    rows in flight an SM (a block keeps SK_STAGES - 1 of its stages in
    flight), the fewest splits on a tie. (Measured on an H100 at the tuning
    shape, B = 8, 4096 x 11008, g = 128: each width ran fastest with 47-56 KB
    in flight an SM, but INT4 at 16 columns, with 31 KB.)"""
    def key(p):
        block_bytes = (_SK_STAGES - 1) * _SK_ROWS * p.threads // 32 * p.warp_cols
        return abs(math.prod(p.grid) - _INFLIGHT * sms / block_bytes), p.splits

    plans = split_candidates(name, m, d, n_out, group_size, cols)
    if not plans:
        raise ValueError(f"{name}: no split of D = {d} in groups of {group_size} fits a block's "
                         "shared memory")
    return min(plans, key=key)


_SMS: dict = {}  # device index -> SM count
_TICKETS: dict = {}  # (device index, stream) -> zeroed int32 counters


def _sm_count(device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device.index]


def _tickets(device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed counters for launches on the current stream: the
    kernels leave them zeroed, so they are allocated once per stream (calls
    on one stream run in order; another stream gets its own)."""
    key = (device.index, _build.stream_ptr(device))
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return t


def _workspace(p: SplitPlan, device):
    """The f32 partial sums and the counters split-K launch ``p`` needs on
    ``device`` (None, None when it does not split across blocks)."""
    if p.ws_shape is None:
        return None, None
    return torch.empty(p.ws_shape, dtype=torch.float32, device=device), _tickets(device, p.tickets)


def plan_of(name: str, x: torch.Tensor, qa, cols: int) -> Optional[SplitPlan]:
    """The split-K launch variant ``name`` takes for x on carrier ``qa``
    (None for the other variants and on the CPU, where no kernel runs)."""
    if name not in SPLIT_K or x.device.type != "cuda":
        return None
    return split_plan(name, x.shape[0], x.shape[1], qa.d_rest, qa.group_size, cols,
                      _sm_count(x.device))


def _run(name, plain, x, q, tables, group_size, n_out, cols):
    d, fp = _check(name, x, q, tables, group_size, n_out, cols)
    if x.device.type == "cpu":
        return plain(x, q, *tables, group_size, n_out)
    out = torch.empty((x.shape[0], n_out), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return out
    fn = getattr(_build.lib(), f"ff_qmm_v_{name}")
    ptrs = [x.data_ptr(), q.data_ptr(), *[t.data_ptr() for t in tables], out.data_ptr()]
    dims = [x.shape[0], d, fp, n_out, group_size, cols]
    if name in SPLIT_K:
        p = split_plan(name, x.shape[0], d, n_out, group_size, cols, _sm_count(x.device))
        ws, tk = _workspace(p, x.device)
        ptrs += [0 if ws is None else ws.data_ptr(), 0 if tk is None else tk.data_ptr()]
        # the launcher refuses a workspace or counters smaller than its own geometry asks
        dims += [p.splits, 0 if ws is None else ws.numel(), 0 if tk is None else tk.numel()]
    err = fn(*ptrs, *dims, _build.stream_ptr(x.device))
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
