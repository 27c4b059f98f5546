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

Two more layouts, JAX's ``shard_params(expert_parallel=, hybrid_ffn=)``:

- ``hybrid_ffn``: the FFN (``wg``, ``wu``, ``bu``, ``wd``) cut over the
  ``("model", "data")`` ranks, attention on ``model`` alone. The FFN's
  block is JAX's for ``P(("model", "data"))``, model-major: block
  ``model_rank * data + data_rank`` of ``T * D``, so each rank's carrier is
  byte for byte JAX's shard although the port numbers its ranks data-major.
  The FFN's row-parallel sum runs over that group (``Shard.ffn_axis``). A
  float MoE expert stack is not hybrid-cut (it stays TP within each expert
  on ``model``) while a quantized one is, as JAX's rules place them. Every
  rank holds every request slot: the data axis carries the FFN, not
  requests (JAX shards its cache's slots on ``data``; the values agree).
- ``expert_parallel``: a float MoE layer's ``[L, E, ...]`` stacks keep the
  rank's ``E / T`` whole experts (``Shard.experts``; JAX's
  ``_MOE_EP_RULES``), the router replicated; the decoder computes the
  rank's experts and sums the combine over ``model``. Where ``E % T != 0``
  the stacks stay whole (not cut within experts either). Quantized expert
  carriers ignore it and keep TP within each expert: JAX's
  ``_QUANT_RULES`` have no EP form.

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

Pipeline stages (``pipe > 1``): a rank holds only its stage's contiguous
block of layers (``parallel/pipeline.stage_range``; ``Shard.layers``),
each ``[L, ...]`` layer leaf cut to ``[L/P, ...]`` (or to an uneven
stage's count, ``stage_sizes``) before the tensor parallel cut, and only
the top leaves its stage runs: stage 0 the embeddings, the last stage the
final norm and ``lm_head`` (and ``embed_tokens`` too where the embeddings
are tied). JAX replicates every top leaf on every stage
(``pp_engine.py:182-184``). :func:`gather_params` gathers the stages too.

Context parallelism (``seq > 1``): the weights are replicated over
``seq`` (every cut above is the same on each seq rank); a serving engine
cuts its verifier's KV cache on the position axis (:class:`SeqCut`,
:func:`with_seq`): seq rank ``c`` of C holds the global positions ``[c
S/C, (c+1) S/C)``, as JAX's ``kv_cache_sharding`` places them, and where
``S % C != 0`` or ``S < C`` the cache stays whole and no seq collective
runs (JAX's ``_divisible``).

The tree carries no mark of its cut: :func:`shard_params` keeps a leaf
whose axis has the rank's width already, so it is idempotent, and the
engines and the Trainer hold the :class:`Shard` beside the tree
(``decoder.forward(shard=)``). :func:`gather_params` is its inverse for
float leaves; :func:`shard_lora` / :func:`gather_lora` cut and gather LoRA
stacks alike (``B``'s columns for wq, wk, wv, wg, wu; ``A``'s rows for wo
and wd); :func:`data_rows` is a data rank's block of a batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from flexflow_tpu_torch.parallel.mesh import FFN_AXES, MODEL_AXIS, PIPE_AXIS, Axis, Mesh
from flexflow_tpu_torch.parallel.pipeline import stage_range, stage_slice
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


@dataclasses.dataclass(frozen=True)
class SeqCut:
    """Seq rank ``rank``'s block of a KV cache's positions: the global
    positions ``[lo, hi)`` of a cache of ``size`` positions, held at local
    indices ``[0, hi - lo)``."""

    lo: int
    hi: int
    size: int
    rank: int

    @property
    def local(self) -> int:
        """Positions the rank's cache holds."""
        return self.hi - self.lo


def seq_cut(mesh: Optional[Mesh], max_seq_len: int) -> Optional[SeqCut]:
    """This rank's :class:`SeqCut` of a cache of ``max_seq_len`` positions,
    or None where the cache stays whole: no mesh, ``seq == 1``, or a length
    the seq axis does not divide (JAX's ``_divisible``)."""
    if mesh is None or mesh.seq == 1:
        return None
    n, c = mesh.seq, mesh.seq_rank
    if max_seq_len % n or max_seq_len < n:
        return None
    w = max_seq_len // n
    return SeqCut(c * w, (c + 1) * w, max_seq_len, c)


def first_position(shard: Optional["Shard"]) -> int:
    """The first global position of the KV cache ``shard`` cuts (0 without
    a seq cut)."""
    return 0 if shard is None or shard.seq is None else shard.seq.lo


def with_seq(shard: "Shard", max_seq_len: int) -> "Shard":
    """``shard`` with the seq cut of a cache of ``max_seq_len`` positions
    (the decoder's attention then merges over the ``seq`` group)."""
    return dataclasses.replace(shard, seq=seq_cut(shard.mesh, max_seq_len))


@dataclasses.dataclass(eq=False)
class Shard:
    """One rank's cut of a model: which global heads, KV heads, FFN columns,
    experts, vocabulary rows and (its pipeline stage's) layers it holds
    (None: the whole axis, replicated), which of its KV cache's positions
    (``seq``, set by :func:`with_seq`), and the mesh whose collectives the
    decoder runs."""

    mesh: Mesh
    heads: Optional[Blocks]  # Q heads of wq / wo (None: attention replicated)
    kv_heads: Optional[Blocks]  # KV heads of wk / wv (None: projected whole)
    kv_take: Optional[Tuple[int, ...]]  # of the projected KV heads, those the cache holds
    ffn: Optional[Blocks]  # FFN columns of wg / wu, rows of wd
    vocab: Optional[Tuple[int, int]]  # embed_tokens rows, lm_head columns
    sizes: Dict[str, int] = dataclasses.field(default_factory=dict)  # each cut's full width
    ffn_axis: Axis = MODEL_AXIS  # the ranks the FFN's row-parallel sum runs over
    experts: Optional[Blocks] = None  # expert_parallel: the rank's global expert ids
    layout: Dict[str, bool] = dataclasses.field(default_factory=dict)  # rank_shard's flags
    layers: Optional[Tuple[int, int]] = None  # pipeline stage: its global layers [lo, hi)
    seq: Optional[SeqCut] = None  # the KV cache's positions this rank holds (None: all)
    _index: Dict[Any, torch.Tensor] = dataclasses.field(default_factory=dict, repr=False)

    @property
    def ffn_partial(self) -> bool:
        """Whether the rank's FFN output is a partial sum: its FFN columns
        (or its experts) are a cut."""
        return self.ffn is not None or self.experts is not None

    def expert_ids(self) -> Optional[Tuple[int, ...]]:
        """The global ids of the rank's experts, in stack order (None: all)."""
        return None if self.experts is None else _expand(self.experts)

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
               int4_wd: bool = False, hybrid_ffn: bool = False,
               expert_parallel: bool = False, quant_ffn: bool = False,
               stage_sizes: Optional[Tuple[int, ...]] = None) -> Shard:
    """This rank's :class:`Shard` of ``spec``. ``int4_wo`` / ``int4_wd``:
    those row-parallel weights are planar INT4 carriers (two-block cuts).
    ``hybrid_ffn`` / ``expert_parallel``: the layouts of the module
    docstring; ``quant_ffn``: the FFN's weights are quantized carriers
    (a MoE model's expert stacks then follow JAX's quantized rules).
    ``stage_sizes``: uneven pipeline stages' layer counts (default: equal
    stages)."""
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
    moe = spec.moe is not None
    f = spec.intermediate_size  # an expert's width too
    ffn_axis, experts = MODEL_AXIS, None
    if hybrid_ffn and (quant_ffn or not moe):
        ffn = _even_blocks(f, t * mesh.data, r * mesh.data + mesh.data_rank, int4_wd)
        ffn_axis = FFN_AXES
    elif moe and expert_parallel and not quant_ffn:
        ffn, experts = None, _even_blocks(spec.moe.num_experts, t, r, False)
    else:
        ffn = _even_blocks(f, t, r, int4_wd)
    v = spec.vocab_size
    vocab = (r * v // t, (r + 1) * v // t) if v % t == 0 and v >= t else None
    sizes = dict(heads=hh, kv=kh, ffn=f, vocab=v, experts=spec.moe.num_experts if moe else 0,
                 layers=spec.num_layers)
    stage_sizes = None if stage_sizes is None else tuple(int(n) for n in stage_sizes)
    layout = dict(int4_wo=int4_wo, int4_wd=int4_wd, hybrid_ffn=hybrid_ffn,
                  expert_parallel=expert_parallel, quant_ffn=quant_ffn, stage_sizes=stage_sizes)
    layers = (stage_range(spec.num_layers, mesh.pipe, mesh.pipe_rank, stage_sizes)
              if mesh.pipe > 1 else None)
    return Shard(mesh, heads, kv_heads, kv_take, ffn, vocab, sizes, ffn_axis, experts, layout,
                 layers)


def slot_block(num_slots: int, mesh: Optional[Mesh], hybrid_ffn: bool = False) -> Tuple[int, int]:
    """Data rank d's request slots ``[lo, hi)``: a contiguous block of
    ``num_slots / data``, or every slot when the count does not divide or
    the data axis carries a hybrid FFN."""
    if mesh is None or mesh.data == 1 or num_slots % mesh.data or hybrid_ffn:
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
_EXPERT_STACKS = ("wg", "wu", "wd")  # [L, E, ...]: the expert axis is -3
_FIRST_STAGE_TOP = ("embed_tokens", "embed_pos")
_LAST_STAGE_TOP = ("final_norm_scale", "final_norm_bias", "lm_head", "lm_head_bias")


def stage_keeps(name: str, shard: Optional[Shard], tied: bool) -> bool:
    """Whether this rank's pipeline stage holds the top leaf ``name``:
    stage 0 the embeddings, the last stage the final norm and the head
    (``embed_tokens`` too where ``tied``: no ``lm_head``); every top leaf
    without stages."""
    if shard is None or shard.layers is None:
        return True
    mesh = shard.mesh
    if name in _FIRST_STAGE_TOP or name in _LAST_STAGE_TOP:
        return ((mesh.first_stage and name in _FIRST_STAGE_TOP)
                or (mesh.last_stage and (name in _LAST_STAGE_TOP
                                         or (tied and name == "embed_tokens"))))
    return True


def _rule(name: str, shard: Shard, top: bool) -> Optional[Tuple[int, str]]:
    """(axis, cut) of the leaf ``name`` under ``shard``, or None."""
    if not top and shard.experts is not None and name in _EXPERT_STACKS:
        return -3, "experts"
    return (_TOP_AXES if top else _LAYER_AXES).get(name)


def _blocks_of(shard: Shard, cut: str) -> Optional[Blocks]:
    if cut == "vocab":
        return None if shard.vocab is None else (shard.vocab,)
    return {"heads": shard.heads, "kv": shard.kv_heads, "ffn": shard.ffn,
            "experts": shard.experts}[cut]


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


def _cut_already(name: str, width: int, shard: Shard, cut: str, blocks: Blocks) -> bool:
    """Whether a leaf's axis of ``width`` needs no cut (True): it is the
    rank's cut already, or the rank's cut is the whole axis (one rank on
    it: the leaf is kept, not copied); False for the whole axis of a cut.
    Any other width raises."""
    full, mine = shard.sizes[cut], sum(b - a for a, b in blocks)
    if width not in (full, mine):
        raise ValueError(f"{name}: an axis of {width} is neither the whole {cut} axis ({full}) "
                         f"nor this rank's cut of it ({mine})")
    return width == mine


def shard_leaf(name: str, leaf, shard: Optional[Shard], *, top: bool = False):
    """This rank's cut of the leaf ``name`` (a layer leaf stacked [L, ...],
    or a top-level leaf with ``top``): a tensor or a carrier. Leaves the
    rules do not name, axes that do not divide, and every leaf without a
    shard (None) come back whole."""
    if shard is None:
        return leaf
    if not top and shard.layers is not None and leaf is not None:
        lo, hi = shard.layers
        if leaf.shape[0] == shard.sizes["layers"]:
            leaf = stage_slice(leaf, lo, hi)
        elif leaf.shape[0] != hi - lo:
            raise ValueError(f"{name}: {leaf.shape[0]} layers are neither the whole stack "
                             f"({shard.sizes['layers']}) nor this stage's {hi - lo}")
    rule = _rule(name, shard, top)
    if rule is None or leaf is None:
        return leaf
    axis, cut = rule
    blocks = _blocks_of(shard, cut)
    if blocks is None or _cut_already(name, leaf.shape[len(leaf.shape) + axis], shard, cut,
                                      blocks):
        return leaf
    if not isinstance(leaf, QuantizedArray):
        return _take(leaf, leaf.dim() + axis, blocks)
    if cut == "experts":
        raise ValueError(f"{name}: expert_parallel cuts float expert stacks; a quantized one "
                         "keeps TP within each expert (a Shard built with quant_ffn)")
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


def tree_shard(spec: ModelSpec, params, mesh: Mesh, *, expert_parallel: bool = False,
               hybrid_ffn: bool = False, stage_sizes=None) -> Shard:
    """The :class:`Shard` of this rank for ``params`` (whole or cut) under
    the layout the flags name: its row-parallel carriers say whether the
    cuts are planar (INT4) and whether the FFN is quantized."""
    layers = params["layers"]
    return rank_shard(spec, mesh, int4_wo=_int4(layers.get("wo")),
                      int4_wd=_int4(layers.get("wd")), hybrid_ffn=hybrid_ffn,
                      expert_parallel=expert_parallel,
                      quant_ffn=isinstance(layers.get("wd"), QuantizedArray),
                      stage_sizes=stage_sizes)


def shard_params(spec: ModelSpec, params, mesh: Mesh, *, expert_parallel: bool = False,
                 hybrid_ffn: bool = False, stage_sizes=None):
    """This rank's parameter tree, cut from a whole (one-device) tree (JAX's
    signature: tensor parallelism, or the ``expert_parallel`` /
    ``hybrid_ffn`` layouts of the module docstring); a leaf cut already is
    kept, so a rank's own tree comes back as it is. Under pipeline stages
    it keeps the rank's stage of the layers and the top leaves its stage
    runs (:func:`stage_keeps`); ``stage_sizes``: uneven stages' layer
    counts. A fused tree (``wqkv``, ``wgu``) must be a rank's tree already
    (an engine's): the rank fuses its own cuts, and a whole fused tree is
    refused."""
    layers = params["layers"]
    shard = tree_shard(spec, params, mesh, expert_parallel=expert_parallel,
                       hybrid_ffn=hybrid_ffn, stage_sizes=stage_sizes)
    fused = {"wqkv": (-2, shard.num_heads(spec) + 2 * shard.num_kv_proj(spec)),
             "wgu": (-1, 2 * sum(b - a for a, b in shard.ffn or ((0, spec.intermediate_size),)))}
    for name, (axis, width) in fused.items():
        if name in layers and layers[name].shape[len(layers[name].shape) + axis] != width:
            raise ValueError("shard_params takes an unfused tree (wq/wk/wv, wg/wu) or a "
                             f"rank's fused one; {name} has the wrong width")
    tied = "lm_head" not in params
    out = {k: shard_leaf(k, v, shard, top=True) for k, v in params.items()
           if k != "layers" and stage_keeps(k, shard, tied)}
    out["layers"] = {k: shard_leaf(k, v, shard) for k, v in layers.items()}
    return out


def _rank_blocks(shard: Shard, cut: str, spec: ModelSpec):
    """(the group ``cut`` is split over, every rank's blocks of it in the
    group's order), or None when the axis is whole."""
    if _blocks_of(shard, cut) is None:
        return None
    mesh = shard.mesh
    axis = shard.ffn_axis if cut == "ffn" else MODEL_AXIS
    return axis, [_blocks_of(rank_shard(spec, Mesh.fake(mesh.data, mesh.model, r,
                                                  pipe=mesh.pipe, seq=mesh.seq),
                                        **shard.layout), cut)
                  for r in mesh.group_ranks(axis)]


def _gather_axis(x: torch.Tensor, dim: int, per_rank, inner: int, full: int, mesh: Mesh):
    """The whole axis ``dim`` of ``x`` from every rank's cut (``per_rank``:
    the group and each rank's blocks, scaled by ``inner`` elements a unit)."""
    axis, per_rank = per_rank
    parts = mesh.all_gather(x, dim, axis).split(x.shape[dim], dim)
    shape = list(x.shape)
    shape[dim] = full * inner
    out = x.new_empty(shape)
    for part, blocks in zip(parts, per_rank):
        off = 0
        for a, b in blocks:
            n = (b - a) * inner
            out.narrow(dim, a * inner, n).copy_(part.narrow(dim, off, n))
            off += n
    return out


def gather_params(spec: ModelSpec, params, mesh: Mesh):
    """The whole (one-device) tree on every rank from each rank's tensor
    parallel cut and pipeline stage: the inverse of :func:`shard_params`
    for float leaves (a cut carrier raises). A collective over ``model``,
    and over ``pipe`` under (equal) stages: each stage's layers in stage
    order, each top leaf from the stage that holds it (:func:`stage_keeps`).
    Every rank calls it."""
    shard = tree_shard(spec, params, mesh)

    def whole(name, leaf, top):
        rule = _rule(name, shard, top)
        if rule is None or leaf is None:
            return leaf
        axis, cut = rule
        per_rank = _rank_blocks(shard, cut, spec)
        if per_rank is None:
            return leaf
        if isinstance(leaf, QuantizedArray):
            raise TypeError(f"gather_params takes float leaves; {name} is quantized")
        return _gather_axis(leaf, leaf.dim() + axis, per_rank, 1, shard.sizes[cut], mesh)

    out = {k: whole(k, v, True) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: whole(k, v, False) for k, v in params["layers"].items()}
    return out if shard.layers is None else _gather_stages(out, shard)


_FLOAT_CODES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_TOP_DIMS = 2  # a top leaf is [V, H], [P, H], [H, V], [V] or [H]


def _gather_stages(tree, shard: Shard):
    """A stage's whole (model-gathered) tree -> the whole model's, over
    ``pipe``: every stage's layers in stage order, and each top leaf from
    the stage that holds it (stage 0 the embeddings, the last stage the
    final norm and the head), after a header from that stage of which
    leaves it holds, their dtypes and shapes."""
    mesh = shard.mesh
    lo, hi = shard.layers
    layers = {}
    for k, v in tree["layers"].items():
        if v.shape[0] != hi - lo:
            raise ValueError(f"gather_params gathers equal stages: layer leaf {k} has "
                             f"{v.shape[0]} layers, stage {mesh.pipe_rank} {hi - lo}")
        layers[k] = mesh.all_gather(v, 0, PIPE_AXIS)
    dev = next(iter(layers.values())).device
    staged = _FIRST_STAGE_TOP + _LAST_STAGE_TOP
    out = {k: v for k, v in tree.items() if k != "layers" and k not in staged}
    for stage, names in ((0, _FIRST_STAGE_TOP), (mesh.pipe - 1, _LAST_STAGE_TOP)):
        mine = mesh.pipe_rank == stage
        rows = []
        for k in names:
            v, row = tree.get(k), [0] * (2 + _TOP_DIMS)
            if mine and v is not None:
                row[:2 + v.dim()] = [_FLOAT_CODES.index(v.dtype) + 1, v.dim(), *v.shape]
            rows.append(row)
        head = mesh.broadcast_from_stage(torch.tensor(rows, dtype=torch.int64, device=dev),
                                         stage)
        for k, (code, nd, *dims) in zip(names, head.tolist()):
            if code:
                buf = (tree[k].contiguous() if mine
                       else torch.empty(dims[:nd], dtype=_FLOAT_CODES[code - 1], device=dev))
                out[k] = mesh.broadcast_from_stage(buf, stage)
    out["layers"] = layers
    return out


# LoRA module -> (stack, axis of the JAX stack layout [L, N, ...], cut); the
# flat feature axis counts head_dim elements a head
_LORA_AXES: Dict[str, Tuple[str, int, str]] = {
    "wq": ("b", 3, "heads"), "wk": ("b", 3, "kv"), "wv": ("b", 3, "kv"),
    "wg": ("b", 3, "ffn"), "wu": ("b", 3, "ffn"),
    "wo": ("a", 2, "heads"), "wd": ("a", 2, "ffn"),
}


def _lora_inner(spec: ModelSpec, cut: str) -> int:
    return spec.head_dim if cut in ("heads", "kv") else 1


def shard_lora(spec: ModelSpec, lora, shard: Shard):
    """This rank's cut of LoRA stacks ({mod: {"a": [L, N, D_in, r], "b":
    [L, N, r, D_out]}}): a column-parallel module's ``b`` takes the rank's
    output columns (``a`` replicated), a row-parallel one's ``a`` the
    rank's input rows (``b`` replicated); under ``hybrid_ffn`` wg / wu /
    wd follow the hybrid FFN cut. Where the K/V heads are projected
    whole (``kv_take``) wk / wv keep whole ``b``s: the decoder adds their
    deltas before it takes the rank's heads, as it projects them."""
    out = {}
    for mod, ab in lora.items():
        which, axis, cut = _LORA_AXES[mod]
        blocks = _blocks_of(shard, cut)
        ab = dict(ab)
        if blocks is not None:
            inner = _lora_inner(spec, cut)
            ab[which] = _take(ab[which], axis, tuple((a * inner, b * inner) for a, b in blocks))
        out[mod] = ab
    return out


def gather_lora(spec: ModelSpec, lora, shard: Shard):
    """The whole stacks on every rank from each rank's :func:`shard_lora`
    cut (a collective over each cut's group)."""
    out = {}
    for mod, ab in lora.items():
        which, axis, cut = _LORA_AXES[mod]
        per_rank = _rank_blocks(shard, cut, spec)
        ab = dict(ab)
        if per_rank is not None:
            ab[which] = _gather_axis(ab[which], axis, per_rank, _lora_inner(spec, cut),
                                     shard.sizes[cut], shard.mesh)
        out[mod] = ab
    return out


def lora_partial_grads(shard: Optional[Shard]) -> Tuple[Tuple[str, str, Axis], ...]:
    """The (module, "a" or "b", the group it is partial over) LoRA leaves
    whose gradient on a rank is partial: a column target's replicated ``a``
    where its region is cut (each rank's columns give their share; over
    ``model``, or the FFN's group for wg / wu), and wk / wv's whole ``b``
    where the K/V heads are projected whole. A row target's ``a`` is the
    rank's own rows and its ``b`` sees the summed ``x @ a``: neither is
    partial."""
    if shard is None:
        return ()
    out = []
    for mod, region, axis in (("wq", shard.heads, MODEL_AXIS), ("wk", shard.heads, MODEL_AXIS),
                              ("wv", shard.heads, MODEL_AXIS), ("wg", shard.ffn, shard.ffn_axis),
                              ("wu", shard.ffn, shard.ffn_axis)):
        if region is not None:
            out.append((mod, "a", axis))
            if mod in ("wk", "wv") and shard.kv_heads is None:
                out.append((mod, "b", axis))
    return tuple(out)


def data_rows(x, mesh: Optional[Mesh]):
    """Data rank d's contiguous block of a batch's rows (JAX's ``P("data")``
    shard); raises where the batch does not divide over ``data``, as JAX's
    ``device_put`` does."""
    if mesh is None or mesh.data == 1:
        return x
    b = x.shape[0]
    if b % mesh.data:
        raise ValueError(f"a batch of {b} rows does not divide over {mesh.data} data ranks")
    w = b // mesh.data
    return x[mesh.data_rank * w:(mesh.data_rank + 1) * w]


def partial_grads(shard: Optional[Shard]) -> Tuple[str, ...]:
    """Replicated layer leaves whose gradient on a rank is partial over
    ``model``: wk / wv (and their biases) projected whole while the Q heads
    are cut, each rank's K/V feeding only its own heads."""
    if shard is None or shard.heads is None or shard.kv_heads is not None:
        return ()
    return ("wk", "wv", "bk", "bv")


def layer_shard(spec: ModelSpec, mesh: Optional[Mesh], bits: Optional[int], *,
                hybrid_ffn: bool = False) -> Optional[Shard]:
    """For loaders that build a tree layer by layer, quantizing every matmul
    weight with ``bits`` (or none): the rank's :class:`Shard` (None without
    a mesh)."""
    if mesh is None:
        return None
    return rank_shard(spec, mesh, int4_wo=bits == 4, int4_wd=bits == 4, hybrid_ffn=hybrid_ffn,
                      quant_ffn=bool(bits))

