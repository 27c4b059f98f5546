"""Megatron tensor parallelism, rank by rank (port of
``flexflow_tpu/parallel/sharding.py``'s rules).

JAX writes the layout as GSPMD ``PartitionSpec``s and lets XLA place the
arrays and insert the collectives. The port cuts each rank's own tree
(``shard_params``) and the decoder issues the collectives
(``models/decoder.py``):

- column-parallel ``wq``/``wk``/``wv`` (and their biases), ``wg``/``wu``
  (``bu``): the rank's heads / FFN columns, no collective;
- row-parallel ``wo`` and ``wd``: the rank's rows; the partial outputs are
  summed over ``model`` in float32, then the bias, then one rounding;
- vocab-parallel ``embed_tokens`` (a masked lookup, then a sum) and
  ``lm_head`` (local float32 logits, gathered along the vocabulary);
- MoE experts: TP within each expert (JAX's ``_MOE_RULES``), the router
  replicated;
- request slots: data rank ``d`` owns a contiguous block of ``B / data``.

Where a size does not divide its axis the leaf is replicated, as JAX's
``_divisible`` does: heads (attention whole), KV heads (K/V computed whole,
each rank keeping the KV heads its Q heads read), the FFN width, the
vocabulary and the slot count.

Two departures from JAX, both exact:

- attention is cut by whole heads, never by a quantized carrier's flat
  column count (JAX's ``_QUANT_RULES`` cut ``wq``'s ``H * hd`` columns, so
  a head may straddle two ranks there);
- INT4 carriers are planar (packed row i holds features i and i + D/2), so
  a contiguous block of packed rows is two blocks of features. Under INT4
  rank r of T takes the packed rows ``[r D/2T, (r+1) D/2T)`` of ``wo`` and
  ``wd`` (byte for byte JAX's shard of ``q``), i.e. the features
  ``[r D/2T, (r+1) D/2T) + [D/2 + r D/2T, D/2 + (r+1) D/2T)``, and the
  column-parallel slices that feed them (the heads, the FFN columns) are
  those two blocks too. Every group stays in its plane, so each rank's
  carrier dequantizes bit for bit to its slice of the one-device weight.

A row slice whose boundary falls inside a quantization group takes a
smaller group size (halved until it divides), the scales and offsets
repeated: exact.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from flexflow_tpu_torch.parallel.mesh import Mesh
from flexflow_tpu_torch.quant.weight_only import QuantizedArray, _rest_pad
from flexflow_tpu_torch.specs import ModelSpec

Blocks = Tuple[Tuple[int, int], ...]  # [start, stop) ranges, in the rank's order


def _expand(blocks: Blocks) -> Tuple[int, ...]:
    return tuple(i for a, b in blocks for i in range(a, b))


def _even_blocks(n: int, t: int, r: int, planar: bool) -> Optional[Blocks]:
    """Rank r's blocks of an axis of n split over t ranks (two half-plane
    blocks when ``planar``); None when n does not divide (replicated)."""
    parts = 2 * t if planar else t
    if n % parts or n < parts:
        return None
    if planar:
        h, w = n // 2, n // parts
        return ((r * w, (r + 1) * w), (h + r * w, h + (r + 1) * w))
    w = n // t
    return ((r * w, (r + 1) * w),)


@dataclasses.dataclass(eq=False)
class Shard:
    """One rank's cut of a model: which global heads, KV heads, FFN columns
    and vocabulary rows it holds (None: the whole axis, replicated), and
    the mesh whose collectives the decoder runs."""

    mesh: Mesh
    heads: Optional[Blocks]  # Q heads of wq / wo (None: attention replicated)
    kv_heads: Optional[Blocks]  # KV heads of wk / wv (None: projected whole)
    kv_take: Optional[Tuple[int, ...]]  # of the projected KV heads, those the cache holds
    ffn: Optional[Blocks]  # FFN columns of wg / wu, rows of wd
    vocab: Optional[Tuple[int, int]]  # embed_tokens rows, lm_head columns
    _index: Dict[Any, torch.Tensor] = dataclasses.field(default_factory=dict, repr=False)

    def num_heads(self, spec: ModelSpec) -> int:
        return spec.num_heads if self.heads is None else len(_expand(self.heads))

    def num_kv_proj(self, spec: ModelSpec) -> int:
        """KV heads the rank's wk / wv project."""
        return spec.num_kv_heads if self.kv_heads is None else len(_expand(self.kv_heads))

    def num_kv_cache(self, spec: ModelSpec) -> int:
        """KV heads the rank's cache holds."""
        return self.num_kv_proj(spec) if self.kv_take is None else len(self.kv_take)

    def index(self, what: str, device) -> torch.Tensor:
        """A cached int64 index tensor on ``device``: ``"heads"`` (the Q
        heads) or ``"kv_take"``. Made at the first (eager) call, so a CUDA
        graph captured later reads it without a host copy."""
        key = (what, str(device))
        if key not in self._index:
            vals = _expand(self.heads) if what == "heads" else self.kv_take
            self._index[key] = torch.tensor(vals, dtype=torch.int64, device=device)
        return self._index[key]


def rank_shard(spec: ModelSpec, mesh: Mesh, *, int4_wo: bool = False,
               int4_wd: bool = False) -> Shard:
    """This rank's :class:`Shard` of ``spec``. ``int4_wo`` / ``int4_wd``:
    those row-parallel weights are planar INT4 carriers (two-block cuts)."""
    t, r = mesh.model, mesh.model_rank
    hh, kh = spec.num_heads, spec.num_kv_heads
    heads = _even_blocks(hh, t, r, int4_wo)
    kv_heads = kv_take = None
    if heads is not None:
        q = _expand(heads)
        grp = hh // kh
        need = [g // grp for g in q]
        kv_heads = _even_blocks(kh, t, r, int4_wo)
        kv = _expand(kv_heads) if kv_heads is not None else ()
        if not kv or need != [kv[j * len(kv) // len(q)] for j in range(len(q))]:
            # K/V projected whole; the cache keeps the heads these Q heads
            # read: each once when they group evenly, else one per Q head
            kv_heads = None
            uniq = list(dict.fromkeys(need))
            even = len(q) % len(uniq) == 0 and all(
                need[j] == uniq[j // (len(q) // len(uniq))] for j in range(len(q)))
            take = tuple(uniq if even else need)
            kv_take = None if take == tuple(range(kh)) else take
    ffn = _even_blocks(spec.intermediate_size, t, r, int4_wd)  # an expert's width too
    v = spec.vocab_size
    vocab = (r * v // t, (r + 1) * v // t) if v % t == 0 and v >= t else None
    return Shard(mesh, heads, kv_heads, kv_take, ffn, vocab)


def slot_block(num_slots: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """Data rank d's request slots ``[lo, hi)``: a contiguous block of
    ``num_slots / data``, or every slot when the count does not divide."""
    if mesh is None or mesh.data == 1 or num_slots % mesh.data:
        return 0, num_slots
    w = num_slots // mesh.data
    return mesh.data_rank * w, (mesh.data_rank + 1) * w


# leaf name -> (axis counted from the end of the logical shape, which cut)
_LAYER_AXES: Dict[str, Tuple[int, str]] = {
    "wq": (-2, "heads"), "bq": (-2, "heads"),
    "wk": (-2, "kv"), "bk": (-2, "kv"),
    "wv": (-2, "kv"), "bv": (-2, "kv"),
    "wo": (-3, "heads"),
    "wg": (-1, "ffn"), "wu": (-1, "ffn"), "bu": (-1, "ffn"),
    "wd": (-2, "ffn"),
}
_TOP_AXES: Dict[str, Tuple[int, str]] = {
    "embed_tokens": (-2, "vocab"), "lm_head": (-1, "vocab"), "lm_head_bias": (-1, "vocab"),
}


def _blocks_of(shard: Shard, cut: str) -> Optional[Blocks]:
    if cut == "vocab":
        return None if shard.vocab is None else (shard.vocab,)
    return {"heads": shard.heads, "kv": shard.kv_heads, "ffn": shard.ffn}[cut]


def _take(x: torch.Tensor, dim: int, blocks: Blocks) -> torch.Tensor:
    return torch.cat([x.narrow(dim, a, b - a) for a, b in blocks], dim=dim).contiguous()


def slice_carrier_columns(qa: QuantizedArray, cols: Blocks) -> QuantizedArray:
    """The flat output columns ``cols`` of a carrier, re-padded for its new
    width: byte for byte the carrier's own columns."""
    n = sum(b - a for a, b in cols)
    pad = _rest_pad(qa.d_contract, n)

    def cut(t):
        if t is None:
            return None
        out = _take(t, t.dim() - 1, cols)
        return torch.nn.functional.pad(out, (0, pad)).contiguous() if pad else out

    return dataclasses.replace(qa, q=cut(qa.q), scale=cut(qa.scale), offset=cut(qa.offset),
                               rest_pad=pad)


def slice_carrier_rows(qa: QuantizedArray, rows: Blocks) -> QuantizedArray:
    """The contraction features ``rows`` of a carrier. INT8: the rows as
    they are. INT4 (planar): ``rows`` must be ``[p0, p1) + [D/2 + p0, D/2 +
    p1)``; the carrier keeps packed rows [p0, p1), whose low and high
    nibbles are exactly those features, each in its own plane. The group
    size is halved until every block boundary falls on a group boundary,
    the scales (and offsets) repeated."""
    d, g = qa.d_contract, qa.group_size
    if qa.bits == 4:
        h = d // 2
        if len(rows) == 1 and rows[0] == (0, d):
            rows = ((0, h), (h, d))
        (p0, p1), (c0, c1) = rows
        if (c0, c1) != (h + p0, h + p1):
            raise ValueError(f"an INT4 row cut must be two half-plane blocks, got {rows}")
        cuts = ((p0, p1),)
    else:
        cuts = rows
    g2 = g
    while any(a % g2 or b % g2 for a, b in rows):
        g2 //= 2
    rep = g // g2
    q = _take(qa.q, qa.q.dim() - 2, cuts)

    def tables(t):
        if t is None:
            return None
        if rep > 1:
            t = torch.repeat_interleave(t, rep, dim=-2)
        return _take(t, t.dim() - 2, tuple((a // g2, b // g2) for a, b in rows))

    return dataclasses.replace(qa, q=q, scale=tables(qa.scale), offset=tables(qa.offset),
                               group_size=g2)


def shard_leaf(name: str, leaf, shard: Shard, *, top: bool = False):
    """This rank's cut of the leaf ``name`` (a layer leaf stacked [L, ...],
    or a top-level leaf with ``top``): a tensor or a carrier. Leaves the
    rules do not name, and axes that do not divide, come back whole."""
    rule = (_TOP_AXES if top else _LAYER_AXES).get(name)
    if rule is None or leaf is None:
        return leaf
    axis, cut = rule
    blocks = _blocks_of(shard, cut)
    if blocks is None:
        return leaf
    if not isinstance(leaf, QuantizedArray):
        return _take(leaf, leaf.dim() + axis, blocks)
    shape = qa_shape = leaf.shape
    p = len(qa_shape) + axis
    end_contract = leaf.batch_dims + leaf.contract_dims
    inner = math.prod(qa_shape[p + 1:end_contract] if p < end_contract else qa_shape[p + 1:])
    flat = tuple((a * inner, b * inner) for a, b in blocks)
    out = slice_carrier_rows(leaf, flat) if p < end_contract else slice_carrier_columns(leaf, flat)
    n = sum(b - a for a, b in blocks)
    shape = qa_shape[:p] + (n,) + qa_shape[p + 1:]
    return dataclasses.replace(out, shape=shape)


def _int4(leaf) -> bool:
    return isinstance(leaf, QuantizedArray) and leaf.bits == 4


def shard_params(spec: ModelSpec, params, mesh: Mesh):
    """This rank's parameter tree, cut from a whole (one-device) tree; the
    result carries its :class:`Shard` under ``"_shard"``. A tree whose
    q/k/v or gate/up carriers are fused already (``wqkv``, ``wgu``) is
    refused: the rank fuses its own cuts."""
    layers = params["layers"]
    if "wqkv" in layers or "wgu" in layers:
        raise ValueError("shard_params takes an unfused tree (wq/wk/wv, wg/wu)")
    shard = rank_shard(spec, mesh, int4_wo=_int4(layers.get("wo")),
                       int4_wd=_int4(layers.get("wd")))
    out = {k: shard_leaf(k, v, shard, top=True) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: shard_leaf(k, v, shard) for k, v in params["layers"].items()}
    out["_shard"] = shard
    return out


def layer_cutter(spec: ModelSpec, mesh: Optional[Mesh], bits: Optional[int]):
    """For loaders that build a tree layer by layer: ``(shard, cut(name,
    leaf, top))`` with the rank's cut of each slab (identity without a
    mesh)."""
    if mesh is None:
        return None, lambda name, leaf, top=False: leaf
    shard = rank_shard(spec, mesh, int4_wo=bits == 4, int4_wd=bits == 4)
    return shard, lambda name, leaf, top=False: shard_leaf(name, leaf, shard, top=top)
