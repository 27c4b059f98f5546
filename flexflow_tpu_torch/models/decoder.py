"""Spec-driven decoder-only transformer (port of ``flexflow_tpu/models/decoder.py``:
the dense path and the MoE FFN).

Parameters are the JAX package's dict layout with every per-layer leaf
stacked on a leading [num_layers, ...] axis; the layer ``scan`` becomes a
Python loop. A quantized stacked projection reaches the quant-matmul kernel
with a layer index into the stacked carrier (no per-layer copy); a MoE
layer's experts ([L, E, ...] stacks) with a layer and an expert index.

The MoE FFN (``_moe_mlp``) routes in f32 at full precision and runs the
form ``spec.moe.impl`` names (``ops/moe.py``): ``dense`` (JAX's default,
every expert on every row; static shapes) or ``ragged`` (sort-based
dispatch, group sizes read on the host). JAX routes every row of a padded
prefill; the ragged form here drops the rows at or past ``lengths`` (their
FFN output is zero), which no valid row can see.

Two modes, as in JAX:

- ``forward``: full-prompt causal forward (prefill). ``flash=True`` sends the
  attention through ``ops/kernels/flash_prefill`` at every prompt length
  (no ALiBi, no softcap).
- ``forward_cached``: T new tokens per slot against the KV cache. Without a
  kv mask, extra K/V, ALiBi or softcap the attention is the decode-attention
  kernel: ``decode_attention`` for one token, ``tree_attention`` under a
  tree mask (tree verification, which then gives incremental decoding's
  bits). Everything else (draft expansion over extra K/V, chunked prefill,
  ALiBi, softcap) is the plain ``ops/attention.split_cached_attention``.
  The new K/V are written into the cache in place, layer by layer, after
  that layer's attention (JAX returns an updated cache instead; each layer
  reads only its own cache, so the results agree).

LoRA (JAX ``_apply_lora``): with ``lora`` (the routing layout of
``peft/lora.route_lora``) and ``adapter_ids`` [B] (-1: no adapter) on the
device, each targeted projection gets its row's adapter delta, computed in
float32 and cast once to the projection's dtype, after the fused carriers
are split (wq, wk, wv from ``wqkv``; wg, wu from ``wgu``) and on wo and wd.
A MoE FFN gets none, as in JAX. A row routed to -1 keeps the projection's
output bit for bit. The routing reads nothing on the host, so a CUDA graph
captures it.

Tensor parallelism (``shard=``, this rank's ``parallel/sharding.Shard``;
the tree holds the rank's cut): the row-parallel sums, the vocab-parallel
embedding sum and the logits' gather go through ``parallel/mesh``'s
conjugate collectives, and ``copy_to_model`` marks every column-parallel
input (the normed hidden state into wq/wk/wv and wg/wu, the router logits
and expert inputs of a MoE FFN, the lm_head's input), so a gradient
through a rank's cut is the one-device gradient's cut. LoRA follows the
cut (``sharding.shard_lora``): a column target's delta is its rank's
columns; a row target's (wo, wd) ``x_local @ a[rows]`` is summed over
``model`` in float32, then ``@ b``, the delta added after the base sum.
Under ``hybrid_ffn`` the FFN's copy, its row-parallel sum and wd's LoRA
sum run over the FFN's group (``Shard.ffn_axis``: every model and data
rank) while attention keeps its ``model`` sum; under ``expert_parallel``
a MoE FFN computes the rank's whole experts (``Shard.experts``) and sums
its float32 combine over ``model``.

CPU offload (JAX ``_stream_in``): ``params["layers"]`` may be a
:class:`~flexflow_tpu_torch.models.layer_store.LayerStore` (layers in pinned
host memory, two device slots) instead of the stacked dict. Both forwards
then read layer i from its staged slot (plain leaves at index 0, quantized
ones as ``LayerQuant(slot, 0)``) and release it after the layer, so dense,
MoE and LoRA layers, prefill, chunked prefill and decode all stream.

Pipeline stages (``serving/pp_engine.py``): the tree may hold one stage's
block of layers, whose count the forwards take from the tree (its stacked
leaves' leading axis) and whose cache holds that many layers. On a stage
after the first both forwards take the hidden state entering its first
layer (``hidden=``) in place of embedding tokens, and on a stage before
the last they return the hidden state (``head=False``) in place of
logits; ``first_layer`` (the stage's first global layer) names the
layers' traces. ``kv_sink`` and the cache index the tree's own layers. The
kernel routing, the masks and the ALiBi slopes are the one-device
decoder's, so a stage launches the kernels where one device does.

Context parallelism (``shard.seq``, a ``parallel/sharding.SeqCut``): the
cache holds the rank's block of positions ``[lo, hi)`` at local indices
``[0, hi - lo)``, while positions, ``cache_lens``, the RoPE tables, ALiBi
distances and "columns past S" stay global. ``forward_cached`` computes
each layer's attention state over the block (the decode-attention
kernel's shard form where the one-device path takes the kernel, else
``ops/attention.split_cached_attention_state``), the in-flight tokens
counted on seq rank 0 only, gathers the C states over ``seq`` and merges
them in rank order (``merge_states``: every rank holds the same bits),
and writes only the block's positions. ``forward`` (the prefill) is the
one-device forward on every seq rank (JAX's GSPMD replicates it over
``seq``); the caller's ``kv_sink`` keeps the block's positions
(``commit_kv_windows(first=)``).

KV cache layout: ``[L, B, KH, S, D]`` — one contiguous D-row per position
for coalesced reads on the GPU (JAX keeps ``[L, B, KH, D, S]`` for the TPU's
(8, 128) tiling). Public shapes stay as in JAX: logits ``[B, T, V]`` f32 and
the per-layer K/V ``[L, B, T, KH, D]``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flexflow_tpu_torch.ops import activations as act_lib
from flexflow_tpu_torch.ops import attention as attn_lib
from flexflow_tpu_torch.ops import moe as moe_lib
from flexflow_tpu_torch.ops import norms, rotary
from flexflow_tpu_torch.ops.kernels.decode_attention import (
    decode_attention,
    decode_attention_state,
    merge_states,
    tree_attention,
    tree_attention_state,
    tree_index,
)
from flexflow_tpu_torch.ops.kernels.flash_prefill import flash_prefill
from flexflow_tpu_torch.ops.kernels.quant_matmul import LayerQuant, quant_matmul
from flexflow_tpu_torch.ops.ring_attention import gather_states
from flexflow_tpu_torch.parallel.mesh import (FFN_AXES, MODEL_AXIS, copy_to_model,
                                             gather_from_model, reduce_from_model)
from flexflow_tpu_torch.parallel.sharding import first_position
from flexflow_tpu_torch.peft.lora import RoutedLora
from flexflow_tpu_torch.quant.weight_only import QuantizedArray, concat_rest
from flexflow_tpu_torch.models.layer_store import LayerStore
from flexflow_tpu_torch.specs import ModelSpec

Params = Dict[str, Any]
HostInts = Union[np.ndarray, Sequence[int]]


class KVCache(NamedTuple):
    """Per-slot KV cache stacked over layers, ``[L, B, KH, S, D]`` each."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[3]

    @property
    def num_slots(self) -> int:
        return self.k.shape[1]


def init_kv_cache(spec: ModelSpec, num_slots: int, max_seq_len: int,
                  dtype=torch.bfloat16, device="cpu", num_kv_heads: Optional[int] = None,
                  num_layers: Optional[int] = None) -> KVCache:
    """``num_kv_heads``: a tensor-parallel rank's own count (default the
    spec's); ``num_layers``: a pipeline stage's (default the spec's)."""
    shape = (num_layers or spec.num_layers, num_slots, num_kv_heads or spec.num_kv_heads, max_seq_len,
             spec.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def to_device(x, device: Union[str, torch.device], dtype=np.int32) -> torch.Tensor:
    """Host ints/array -> tensor on ``device`` without a host wait (pinned,
    non-blocking copy for CUDA)."""
    t = torch.as_tensor(np.ascontiguousarray(x, dtype=dtype))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _norm(spec: ModelSpec, h, scale, bias):
    if spec.norm == "rmsnorm":
        return norms.rms_norm(h, scale, spec.norm_eps)
    return norms.layer_norm(h, scale, bias, spec.norm_eps)


def _linear(x, w, b=None, *, dims: int = 1, out_dtype=None):
    """x [..., D] @ w [D, ...out] (+ b), contracting x's last ``dims`` axes
    with w's first; quantized weights go to the kernel. In x's dtype, or
    ``out_dtype`` (float32: a row-parallel partial, the kernel's f32 output
    or an f32 product of a plain weight)."""
    if isinstance(w, LayerQuant):
        out = quant_matmul(x, w.qa, layer=w.layer, out_dtype=out_dtype)
    elif isinstance(w, QuantizedArray):
        out = quant_matmul(x, w, out_dtype=out_dtype)
    elif out_dtype is None:
        out = torch.tensordot(x, w, dims=dims)
    else:
        out = torch.tensordot(x.to(out_dtype), w.to(out_dtype), dims=dims)
    if b is not None:
        out = out + b
    return out.to(out_dtype or x.dtype)


def _apply_lora(p: Params, mod: str, x, out, row_axis=None):
    """``out`` plus module ``mod``'s routed LoRA delta: ``x @ a`` over every
    adapter, weighted by the scale on each row's own adapter and by 0 on
    the others, ``@ b``, in float32, cast once to ``out``'s dtype. Rows
    routed to -1 keep ``out`` bit for bit. ``p["_lora"]`` holds the layer's
    (a [D_in, N*r], b [N*r, D_out]) per module (keyed by module name: fused
    carriers hold no wq...wu). ``row_axis`` (a row-parallel target): ``x``
    and ``a`` are the rank's input features, ``x @ a`` is summed over that
    group."""
    lora = p.get("_lora")
    if lora is None or mod not in lora:
        return out
    a, b = lora[mod]
    bsz = out.shape[0]
    xa = torch.matmul(x.reshape(bsz, -1, a.shape[0]).float(), a)
    if row_axis is not None:
        xa = reduce_from_model(xa, p["_shard"].mesh, row_axis)
    xa = xa * p["_lora_weight"]
    delta = torch.matmul(xa, b).reshape(out.shape).to(out.dtype)
    keep = p["_lora_keep"].reshape((bsz,) + (1,) * (out.dim() - 1))
    return torch.where(keep, out + delta, out)


def _qkv(spec: ModelSpec, p: Params, h):
    """h [B,T,D] -> q [B,T,H,Dh], k/v [B,T,KH,Dh] (a tensor-parallel rank's
    own heads, and the KV heads its cache keeps)."""
    sh = p.get("_shard")
    if sh is not None and sh.heads is not None:
        h = copy_to_model(h, sh.mesh)
    if "wqkv" in p:
        out = _linear(h, p["wqkv"], p.get("bqkv"))
        hh, kh = ((spec.num_heads, spec.num_kv_heads) if sh is None
                  else (sh.num_heads(spec), sh.num_kv_proj(spec)))
        q, k, v = torch.split(out, [hh, kh, kh], dim=-2)
    else:
        q, k, v = (_linear(h, p["wq"], p.get("bq")), _linear(h, p["wk"], p.get("bk")),
                   _linear(h, p["wv"], p.get("bv")))
    hf = h.float() if "_lora" in p else h  # one cast for the three deltas
    q, k, v = _apply_lora(p, "wq", hf, q), _apply_lora(p, "wk", hf, k), _apply_lora(p, "wv", hf, v)
    if sh is not None and sh.kv_take is not None:
        take = sh.index("kv_take", k.device)
        k, v = k.index_select(-2, take), v.index_select(-2, take)
    return q, k, v


def fuse_qkv_params(spec: ModelSpec, params: Params, shard=None) -> Params:
    """Concatenate wq|wk|wv into ``wqkv`` [L, D, H+2KH, Dh] and wg|wu into
    ``wgu`` [L, D, 2F] so a step pays one kernel call per group. Column-exact
    (quantized groups included, via ``concat_rest``). ``shard``: the cut
    ``params`` is (a tensor-parallel rank's)."""
    layers = dict(params["layers"])
    hh, kh = ((spec.num_heads, spec.num_kv_heads) if shard is None
              else (shard.num_heads(spec), shard.num_kv_proj(spec)))
    f = spec.intermediate_size if shard is None or shard.ffn is None else sum(
        b - a for a, b in shard.ffn)

    def _fusable(names):
        ws = [layers.get(n) for n in names]
        if any(w is None for w in ws):
            return None
        if all(isinstance(w, QuantizedArray) for w in ws):
            if len({(w.bits, w.group_size, w.dtype, w.batch_dims, w.contract_dims,
                     w.d_contract) for w in ws}) == 1:
                return ws
            return None
        if not any(isinstance(w, QuantizedArray) for w in ws):
            return ws
        return None

    ws = _fusable(["wq", "wk", "wv"])
    biases = [layers.get(n) for n in ("bq", "bk", "bv")]
    bias_ok = all(b is None for b in biases) or all(b is not None for b in biases)
    if ws is not None and bias_ok:
        if isinstance(ws[0], QuantizedArray):
            layers["wqkv"] = concat_rest(ws, (hh + 2 * kh, spec.head_dim))
        else:
            layers["wqkv"] = torch.cat(ws, dim=2)
        if biases[0] is not None:
            layers["bqkv"] = torch.cat(biases, dim=1)
        for n in ("wq", "wk", "wv", "bq", "bk", "bv"):
            layers.pop(n, None)

    if spec.moe is None and spec.act == "silu_gate":
        ws = _fusable(["wg", "wu"])
        if ws is not None and layers.get("bu") is None:
            if isinstance(ws[0], QuantizedArray):
                layers["wgu"] = concat_rest(ws, (2 * f,))
            else:
                layers["wgu"] = torch.cat(ws, dim=-1)
            for n in ("wg", "wu"):
                layers.pop(n, None)
    return {**params, "layers": layers}


def _row_parallel(p: Params, what: str) -> bool:
    """Whether this rank's ``what`` ("heads" or "ffn") is a row-parallel
    cut (or, for "ffn", a share of the experts) whose partial outputs are
    summed over the mesh. Over a group of one rank (a mesh with one model
    rank, and for a hybrid FFN one data rank too) the cut is the whole
    axis: the one-device product, bit for bit, with nothing to sum."""
    sh = p.get("_shard")
    if sh is None:
        return False
    m = sh.mesh
    if what == "ffn":
        return sh.ffn_partial and m.model * (m.data if sh.ffn_axis == FFN_AXES else 1) > 1
    return sh.heads is not None and m.model > 1


def _reduced(p: Params, partial, bias, dtype, axis=MODEL_AXIS):
    """A row-parallel float32 partial summed over ``axis`` (the model axis,
    or a hybrid FFN's group), the bias added once after the sum, rounded
    once to ``dtype``."""
    out = reduce_from_model(partial.float(), p["_shard"].mesh, axis)
    if bias is not None:
        out = out + bias
    return out.to(dtype)


def _moe_mlp(spec: ModelSpec, p: Params, h, valid=None):
    """Mixtral's sparse MoE FFN (JAX ``_moe_mlp``): an f32 router, then the
    dense or the ragged form of ``ops/moe.py``. ``valid`` [B, T] marks the
    rows the ragged form computes (None: every row). Under tensor
    parallelism each expert is cut (JAX's ``_MOE_RULES``; a quantized one
    over the hybrid FFN's group under ``hybrid_ffn``); under expert
    parallelism the rank holds whole experts (``_MOE_EP_RULES``). Either
    way the f32 combine of the rank's share is summed over the FFN's group
    and rounded once."""
    b, t, d = h.shape
    x = h.reshape(b * t, d)
    # every row through the router in both forms, so a row's routing never
    # depends on which rows the ragged form keeps (nor on the row count)
    router_logits = moe_lib.router_logits(x, p["router"])  # [N, E]
    tp = _row_parallel(p, "ffn")
    sh = p.get("_shard")
    if tp:  # each rank's experts see the router's outputs and the rows
        x = copy_to_model(x, sh.mesh, sh.ffn_axis)
        router_logits = copy_to_model(router_logits, sh.mesh, sh.ffn_axis)
    rows = None
    if spec.moe.impl == "ragged" and valid is not None:
        rows = valid.reshape(-1).nonzero()[:, 0]
        x, router_logits = x[rows], router_logits[rows]
    ffn = moe_lib.moe_ffn_ragged if spec.moe.impl == "ragged" else moe_lib.moe_ffn_dense
    out = ffn(x, router_logits, p["wg"], p["wu"], p["wd"], spec.moe.top_k, partial=tp,
              experts=None if sh is None else sh.expert_ids())
    if rows is not None:
        out = torch.zeros(b * t, d, dtype=out.dtype, device=out.device).index_copy_(0, rows, out)
    if tp:
        out = _reduced(p, out, None, h.dtype, sh.ffn_axis)
    return out.reshape(b, t, d)


def _mlp(spec: ModelSpec, p: Params, h, valid=None):
    if spec.moe is not None:
        return _moe_mlp(spec, p, h, valid)
    tp = _row_parallel(p, "ffn")
    axis = p["_shard"].ffn_axis if tp else None
    if tp:
        h = copy_to_model(h, p["_shard"].mesh, axis)
    if spec.act == "silu_gate":
        if "wgu" in p:
            gate, up = torch.chunk(_linear(h, p["wgu"]), 2, dim=-1)
        else:
            gate, up = _linear(h, p["wg"]), _linear(h, p["wu"])
        hf = h.float() if "_lora" in p else h  # one cast for both deltas
        inner = act_lib.sigmoid_silu_multi(_apply_lora(p, "wg", hf, gate),
                                           _apply_lora(p, "wu", hf, up))
    else:
        inner = act_lib.get_activation(spec.act)(
            _apply_lora(p, "wu", h, _linear(h, p["wu"], p.get("bu"))))
    if tp:
        out = _reduced(p, _linear(inner, p["wd"], out_dtype=torch.float32), p.get("bd"),
                       h.dtype, axis)
        return _apply_lora(p, "wd", inner, out, row_axis=axis)
    out = _linear(inner, p["wd"])
    if p.get("bd") is not None:
        out = out + p["bd"]
    return _apply_lora(p, "wd", inner, out.to(h.dtype))


def _attn_out(spec: ModelSpec, p: Params, a):
    """a [B,T,H,Dh] -> [B,T,D] via wo [H,Dh,D]."""
    wo = p["wo"]
    if _row_parallel(p, "heads"):
        out = _reduced(p, _linear(a, wo, dims=2, out_dtype=torch.float32), p.get("bo"),
                       a.dtype)
        return _apply_lora(p, "wo", a, out, row_axis=MODEL_AXIS)
    if isinstance(wo, LayerQuant):
        out = quant_matmul(a, wo.qa, layer=wo.layer)
    elif isinstance(wo, QuantizedArray):
        out = quant_matmul(a, wo)
    else:
        out = torch.einsum("bthd,hdo->bto", a, wo)
    if p.get("bo") is not None:
        out = out + p["bo"]
    return _apply_lora(p, "wo", a, out.to(a.dtype))


def _layer(spec: ModelSpec, p: Params, h, attend, valid=None):
    """One decoder layer; ``attend(q, k, v) -> attn_out`` is injected.
    ``valid`` [B, T] marks the rows a ragged MoE FFN computes."""
    if spec.parallel_attn:
        ln_attn = _norm(spec, h, p["ln1_scale"], p.get("ln1_bias"))
        if spec.num_ln_in_parallel_attn == 2:
            ln_mlp = _norm(spec, h, p["ln2_scale"], p.get("ln2_bias"))
        else:
            ln_mlp = ln_attn
        a = attend(*_qkv(spec, p, ln_attn))
        return h + _attn_out(spec, p, a) + _mlp(spec, p, ln_mlp, valid)
    if spec.pre_norm:
        a = attend(*_qkv(spec, p, _norm(spec, h, p["ln1_scale"], p.get("ln1_bias"))))
        h = h + _attn_out(spec, p, a)
        return h + _mlp(spec, p, _norm(spec, h, p["ln2_scale"], p.get("ln2_bias")), valid)
    a = attend(*_qkv(spec, p, h))
    h = _norm(spec, h + _attn_out(spec, p, a), p["ln1_scale"], p.get("ln1_bias"))
    return _norm(spec, h + _mlp(spec, p, h, valid), p["ln2_scale"], p.get("ln2_bias"))


def _layer_params(layers: Params, i: int) -> Params:
    """Layer i's view: plain leaves indexed, quantized stacks ([L, ...], or
    [L, E, ...] experts) as LayerQuant; from a :class:`LayerStore`, layer i
    copied to the device on its own."""
    if isinstance(layers, LayerStore):
        return layers.layer(i)
    out = {}
    for k, v in layers.items():
        if isinstance(v, QuantizedArray):
            if v.batch_dims not in (1, 2):
                raise ValueError(f"{k}: expected a [L, ...] or [L, E, ...] stacked carrier")
            out[k] = LayerQuant(v, i)
        else:
            out[k] = v[i]
    return out


def _lora_routing(lora: Optional[RoutedLora], adapter_ids: Optional[torch.Tensor],
                  scale: float) -> Optional[Params]:
    """A forward's routing state, on the device: the weight [B, 1, N*r] of
    every adapter column for each row (the scale on the row's own adapter,
    0 elsewhere: JAX's one-hot times the scale) and the rows that have one."""
    if lora is None:
        return None
    if adapter_ids is None:
        raise ValueError("lora needs adapter_ids ([B], -1 for no adapter)")
    ids = adapter_ids.long()
    cols = torch.arange(lora.num_adapters * lora.rank, device=ids.device) // lora.rank
    return {"_lora_weight": (ids[:, None] == cols[None]).float()[:, None] * scale,
            "_lora_keep": ids >= 0}


def _stack_depth(layers) -> int:
    """The number of layers a stacked layer tree (or a LayerStore) holds:
    the spec's, or a pipeline stage's."""
    if isinstance(layers, LayerStore):
        return layers.num_layers
    return next(iter(layers.values())).shape[0]


def _layer_views(spec: ModelSpec, params: Params, lora: Optional[RoutedLora],
                 routing: Optional[Params], shard=None) -> Iterator[Tuple[int, Params]]:
    """(i, layer i's parameters) in the tree's layer order, with the rank's
    ``shard`` (under ``"_shard"``), the layer's adapter weights and the
    routing when the forward has LoRA. From a :class:`LayerStore` (CPU
    offload) layer i is read from its staged slot and released once the
    caller's work on it is enqueued, which starts the copy of layer i + 2
    into that slot."""
    layers = params["layers"]
    store = layers if isinstance(layers, LayerStore) else None
    for i in range(_stack_depth(layers)):
        p = store.acquire(i) if store is not None else _layer_params(layers, i)
        if shard is not None:
            p["_shard"] = shard
        if routing is not None:
            p.update(routing, _lora={m: (lora.a[m][i], lora.b[m][i]) for m in lora.a})
        yield i, p
        if store is not None:
            store.release(i)


def _embed(spec: ModelSpec, params: Params, tokens, positions, sh=None):
    emb = params["embed_tokens"]
    if sh is not None and sh.vocab is not None:
        # vocab-parallel: the rank's rows, zero elsewhere, summed (exact:
        # one rank holds each row)
        local = tokens.long() - sh.vocab[0]
        mine = (local >= 0) & (local < emb.shape[0])
        h = torch.where(mine[..., None], emb[local.clamp(0, emb.shape[0] - 1)].float(), 0.0)
        h = reduce_from_model(h, sh.mesh).to(emb.dtype)
    else:
        h = emb[tokens.long()]
    if spec.embed_scale != 1.0:
        h = h * spec.embed_scale
    if spec.pos == "learned":
        h = h + params["embed_pos"][(positions + spec.learned_pos_offset).long()]
    return h


def _unembed(spec: ModelSpec, params: Params, h, sh=None):
    """h [..., D] -> f32 logits [..., V]."""
    if spec.final_norm:
        h = _norm(spec, h, params["final_norm_scale"], params.get("final_norm_bias"))
    vocab_cut = sh is not None and sh.vocab is not None
    if vocab_cut:
        h = copy_to_model(h, sh.mesh)
    w = params.get("lm_head")
    if isinstance(w, QuantizedArray):
        logits = quant_matmul(h, w, out_dtype=torch.float32)
    else:
        w = params["embed_tokens"].T if w is None else w  # tied
        logits = torch.tensordot(h.float(), w.float(), dims=1)
    if params.get("lm_head_bias") is not None:
        logits = logits + params["lm_head_bias"].float()
    if vocab_cut:
        logits = gather_from_model(logits, sh.mesh, logits.dim() - 1)  # vocab-parallel: exact
    return logits


def _alibi_slopes(spec: ModelSpec, device, shard=None):
    """ALiBi slopes of every head, or of a tensor-parallel rank's own."""
    if spec.pos != "alibi":
        return None
    slopes = attn_lib.alibi_slopes(spec.num_heads, spec.alibi_max_bias, device)
    if shard is not None and shard.heads is not None:
        slopes = slopes.index_select(0, shard.index("heads", device))
    return slopes


def _rope_tables(spec: ModelSpec, positions):
    """cos/sin for ``positions``, built once per forward (None without rope)."""
    if spec.pos != "rope":
        return None
    return rotary.rope_cos_sin(positions, spec.head_dim, spec.rope_theta, spec.rope_scaling)


def _maybe_rope(q, k, tables):
    if tables is None:
        return q, k
    cos, sin = tables
    return rotary.apply_rope(q, cos, sin), rotary.apply_rope(k, cos, sin)


def _gather_rows(x, rows):
    """x [B, T, ...], rows [B] -> x[b, rows[b]] ([B, ...])."""
    return x[torch.arange(x.shape[0], device=x.device), rows.long()]


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def forward(
    spec: ModelSpec,
    params: Params,
    tokens: torch.Tensor,  # [B, T] int
    positions: torch.Tensor,  # [B, T] absolute positions
    *,
    lengths: Optional[torch.Tensor] = None,  # [B] valid lengths (mask padding)
    return_kv: bool = False,
    flash: bool = False,  # caller asserts positions == arange (prefill)
    kv_sink: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]] = None,
    logits_at: Optional[torch.Tensor] = None,  # [B] one position per row
    lora: Optional[RoutedLora] = None,
    adapter_ids: Optional[torch.Tensor] = None,  # [B] adapter per row, -1: none
    lora_scale: float = 1.0,
    traces: Optional[Dict[str, torch.Tensor]] = None,
    shard=None,  # parallel/sharding.Shard: the cut ``params`` is
    hidden: Optional[torch.Tensor] = None,  # [B, T, D] entering the tree's first layer
    head: bool = True,  # False: return the last layer's hidden state
    first_layer: int = 0,  # the tree's first global layer (traces' names)
):
    """Self-attention forward (prefill). Returns ``(logits, kv)``.

    ``logits`` is [B, T, V] f32, or [B, V] at ``logits_at``; ``kv`` is
    ``(k, v)`` stacked [L, B, T, KH, D] when ``return_kv`` else None.
    ``kv_sink(layer, k, v)`` receives each layer's [B, T, KH, D] K/V instead
    of stacking them (the engine writes them straight into its cache).
    ``traces`` (``utils/debug_dump``): a dict that receives every
    intermediate under the reference's names: ``embed_tokens.output``,
    ``layers.<i>.{q_proj,k_proj,v_proj}`` (before rotary),
    ``layers.<i>.attn_output``, ``layers.<i>.output`` and ``lm_head.output``.

    A pipeline stage: ``hidden`` [B, T, D] enters its first layer in place
    of ``tokens`` (which may then be None), and with ``head=False`` the
    first return value is the last layer's hidden state [B, T, D] (or
    [B, D] at ``logits_at``) in place of the logits.
    """
    src = tokens if hidden is None else hidden
    b, t = src.shape[:2]
    dev = src.device
    slopes = _alibi_slopes(spec, dev, shard)
    if hidden is None:
        h = _embed(spec, params, tokens, positions, shard)
        if traces is not None:
            traces["embed_tokens.output"] = h
    else:
        h = hidden
    use_flash = flash and slopes is None and spec.attn_logit_softcap is None

    mask = positions[:, None, :] <= positions[:, :, None]  # [B, T, T]
    valid = None
    if lengths is not None:
        valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]  # [B, T]
        mask = mask & valid[:, None, :]
    flens = (lengths if lengths is not None
             else torch.full((b,), t, device=dev)).to(torch.int32)

    rope = _rope_tables(spec, positions)
    routing = _lora_routing(lora, adapter_ids, lora_scale)

    def attend(q, k, v):
        if traces is not None:
            g = first_layer + i
            traces.update({f"layers.{g}.q_proj": q, f"layers.{g}.k_proj": k,
                           f"layers.{g}.v_proj": v})
        q, k = _maybe_rope(q, k, rope)
        kvs.append((k, v))
        if use_flash:
            out = flash_prefill(q.contiguous(), k.contiguous(), v.to(q.dtype).contiguous(), flens)
        else:
            out = attn_lib.cached_attention(
                q, k, v, cache_lens=torch.zeros(b, dtype=torch.int32, device=dev),
                tree_mask=mask, q_positions=positions, slopes=slopes,
                logit_softcap=spec.attn_logit_softcap)
        if traces is not None:
            traces[f"layers.{first_layer + i}.attn_output"] = out
        return out

    ks, vs = [], []
    for i, p in _layer_views(spec, params, lora, routing, shard):
        kvs = []
        h = _layer(spec, p, h, attend, valid)
        if traces is not None:
            traces[f"layers.{first_layer + i}.output"] = h
        (k, v), = kvs
        if kv_sink is not None:
            kv_sink(i, k, v)
        if return_kv:
            ks.append(k)
            vs.append(v)
    if logits_at is not None:
        h = _gather_rows(h, logits_at)
    kv = (torch.stack(ks), torch.stack(vs)) if return_kv else None
    if not head:
        return h, kv
    logits = _unembed(spec, params, h, shard)
    if traces is not None:
        traces["lm_head.output"] = logits
    return logits, kv


def _window_index(starts: HostInts, t: int, s: int, device, first: int = 0):
    """Host-side (slot, local position, update-row) indices of the in-range
    columns of windows [starts[b], starts[b] + t), clipped at S, in a cache
    holding the global positions [first, first + s); None if empty."""
    st = np.clip(np.asarray(starts, dtype=np.int64), 0, first + s)
    pos = st[:, None] + np.arange(t)[None, :] - first
    bi, ti = np.nonzero((pos >= 0) & (pos < s))
    if bi.size == 0:
        return None
    return tuple(to_device(a, device, np.int64) for a in (bi, pos[bi, ti], ti))


def device_window(cache_lens: torch.Tensor, t: int, s: int, first: int = 0):
    """Device-side indices of the windows [lens[b], lens[b] + t) of a cache of
    S positions, with no host read: (slot [B, t], position [B, t], keep
    [B, t]). ``first``: the cache holds the global positions [first, first
    + S) (a seq rank's block; 0 the whole cache) at local indices. A column
    outside them (at or past S) is not kept and is aimed at a local index
    no kept column of its row targets (lens[b] - 1, or the one after the
    kept ones), so writing the old value back there drops it. Needs
    t <= S."""
    if t > s:
        raise ValueError(f"a window of {t} columns does not fit a cache of {s} positions")
    start = cache_lens.long()[:, None] - first
    loc = start + torch.arange(t, device=cache_lens.device)[None, :]
    keep = (loc >= 0) & (loc < s)
    # the kept columns are [max(start, 0), min(start + t, s)): the index just
    # before them, or just after where they begin at 0 (t <= s: one is free)
    free = torch.where(start >= 1, (start - 1).clamp(0, s - 1), (start + t).clamp(0, s - 1))
    slots = torch.arange(cache_lens.shape[0], device=cache_lens.device)[:, None].expand(-1, t)
    return slots, torch.where(keep, loc, free), keep


def forward_cached(
    spec: ModelSpec,
    params: Params,
    tokens: torch.Tensor,  # [B, T] (T=1 for decode)
    cache: KVCache,
    cache_lens: torch.Tensor,  # [B] int32 committed tokens per slot
    *,
    positions: Optional[torch.Tensor] = None,  # [B, T]; default lens + arange(T)
    tree_mask: Optional[torch.Tensor] = None,  # [B, T, T] among in-flight tokens
    kv_mask: Optional[torch.Tensor] = None,  # [B, T, S] over the existing cache
    write_start: Optional[HostInts] = None,  # [B] host window start; None: lens
    write_cache: bool = True,  # False: return the new KV instead
    logits_at: Optional[torch.Tensor] = None,  # [B] one position per row
    extra_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # [L, B, E, KH, D] x2
    extra_mask: Optional[torch.Tensor] = None,  # [B, T, E] mask over extra_kv
    extra_positions: Optional[torch.Tensor] = None,  # [B, E] abs positions (alibi)
    attn_window: Optional[int] = None,  # attend only cache[..., :attn_window, :]
    lora: Optional[RoutedLora] = None,
    adapter_ids: Optional[torch.Tensor] = None,  # [B] adapter per row, -1: none
    lora_scale: float = 1.0,
    shard=None,  # parallel/sharding.Shard: the cut ``params`` is
    hidden: Optional[torch.Tensor] = None,  # [B, T, D] entering the tree's first layer
    head: bool = True,  # False: return the last layer's hidden state
):
    """Cached decode / chunk / tree forward. Returns ``(logits [B, T, V] f32,
    cache)`` with the cache updated in place, or ``(logits, (k_new, v_new))``
    stacked [L, B, T, KH, D] when ``write_cache=False``.

    The new K/V land at ``[write_start, write_start + T)``. By default the
    window starts at ``cache_lens`` and its indices are computed on the
    device (``device_window``), so the step reads nothing on the host and a
    CUDA graph can capture it. A host ``write_start`` (a numpy array or
    list; the chunked prefill and the stepwise draft and verify) builds the
    indices on the host instead. Columns past S are dropped either way.

    ``extra_kv`` / ``extra_mask`` put further K/V columns (earlier tree
    depths during draft expansion) in front of the in-flight tokens: the
    attention runs under the joint mask ``[extra_mask | tree_mask or
    causal]``, and under ALiBi the extra columns carry ``extra_positions``.

    ``attn_window`` (>= every row's committed length) limits the plain
    attention path's cache read to the first ``attn_window`` positions; the
    decode kernel reads only positions below ``cache_lens`` anyway.

    A pipeline stage: ``hidden`` and ``head`` as in :func:`forward`; the
    hidden state returned in place of the logits.
    """
    src = tokens if hidden is None else hidden
    b, t = src.shape[:2]
    dev = src.device
    s = cache.max_seq_len  # the positions this cache holds (a seq rank's block)
    cut = None if shard is None else shard.seq
    first = first_position(shard)  # the block's first global position
    slopes = _alibi_slopes(spec, dev, shard)
    cache_lens = cache_lens.to(device=dev, dtype=torch.int32)
    if positions is None:
        positions = cache_lens[:, None] + torch.arange(t, device=dev, dtype=torch.int32)[None, :]
    h = _embed(spec, params, tokens, positions, shard) if hidden is None else hidden

    if write_cache:
        if write_start is None:
            dwin = device_window(cache_lens, t, s, first)
        else:
            widx = _window_index(write_start, t, s, dev, first)
    # the window's part of this block (one column at least: masked)
    window = s if attn_window is None else min(max(attn_window - first, 1), s)
    if kv_mask is not None:
        kv_mask = kv_mask[..., first:first + window]
    joint_mask, joint_positions = tree_mask, None
    if extra_kv is not None:
        if extra_mask is None:
            raise ValueError("extra_kv needs extra_mask")
        base = tree_mask if tree_mask is not None else torch.tril(
            torch.ones(t, t, dtype=torch.bool, device=dev))[None].expand(b, t, t)
        joint_mask = torch.cat([extra_mask, base], dim=-1)
        if slopes is not None:
            # the extra columns keep their own distance bias
            if extra_positions is None:
                raise ValueError("extra_kv under ALiBi needs extra_positions")
            joint_positions = torch.cat(
                [extra_positions.to(device=dev, dtype=torch.int32),
                 positions.to(torch.int32)], dim=1)
    use_kernel = ((t == 1 or tree_mask is not None) and kv_mask is None and extra_kv is None
                  and slopes is None and spec.attn_logit_softcap is None)
    tidx = (tree_index(tree_mask)
            if use_kernel and tree_mask is not None and dev.type == "cuda" else None)
    rope = _rope_tables(spec, positions)
    routing = _lora_routing(lora, adapter_ids, lora_scale)
    plain_kw = dict(new_mask=joint_mask, kv_mask=kv_mask, q_positions=positions,
                    new_positions=joint_positions, slopes=slopes,
                    logit_softcap=spec.attn_logit_softcap)
    # a seq rank's block: the in-flight columns join on seq rank 0 only
    seq_kw = None if cut is None else dict(first=first, inflight=cut.rank == 0)

    new_k, new_v = [], []
    for i, p in _layer_views(spec, params, lora, routing, shard):
        ck_l, cv_l = cache.k[i], cache.v[i]  # [B, KH, S, D]

        def attend(q, k, v):
            q, k = _maybe_rope(q, k, rope)
            # cast once to the cache dtype so attention sees exactly what a
            # later step reads back from the cache
            kc, vc = k.to(ck_l.dtype), v.to(cv_l.dtype)
            if use_kernel and tree_mask is not None:
                args = (q.contiguous(), ck_l, cv_l, kc.contiguous(), vc.contiguous(),
                        cache_lens, tree_mask)
                out = (tree_attention(*args, index=tidx) if cut is None
                       else tree_attention_state(*args, index=tidx, **seq_kw))
            elif use_kernel:
                args = (q[:, 0].contiguous(), ck_l, cv_l, kc[:, 0].contiguous(),
                        vc[:, 0].contiguous(), cache_lens)
                out = (decode_attention(*args) if cut is None
                       else decode_attention_state(*args, **seq_kw))[:, None]
            else:
                kn, vn = kc, vc
                if extra_kv is not None:
                    kn = torch.cat([extra_kv[0][i].to(kc.dtype), kc], dim=1)
                    vn = torch.cat([extra_kv[1][i].to(vc.dtype), vc], dim=1)
                args = (q, ck_l[:, :, :window], cv_l[:, :, :window], kn, vn, cache_lens)
                out = (attn_lib.split_cached_attention(*args, **plain_kw) if cut is None
                       else attn_lib.pack_state(*attn_lib.split_cached_attention_state(
                           *args, **plain_kw, kv_offset=first, with_new=seq_kw["inflight"])))
            if cut is not None:  # this seq rank's states, merged over seq
                out = merge_states(gather_states(out, shard.mesh), q.dtype).reshape(q.shape)
            if write_cache and write_start is None:
                slots, pos, keep = dwin
                keep = keep[:, :, None, None]
                ck_l[slots, :, pos] = torch.where(keep, kc, ck_l[slots, :, pos])
                cv_l[slots, :, pos] = torch.where(keep, vc, cv_l[slots, :, pos])
            elif write_cache:
                if widx is not None:
                    bi, pi, ti = widx
                    ck_l[bi, :, pi] = kc[bi, ti]
                    cv_l[bi, :, pi] = vc[bi, ti]
            else:
                new_k.append(kc)
                new_v.append(vc)
            return out

        h = _layer(spec, p, h, attend)
    if logits_at is not None:
        h = _gather_rows(h, logits_at)
    out = _unembed(spec, params, h, shard) if head else h
    if not write_cache:
        return out, (torch.stack(new_k), torch.stack(new_v))
    return out, cache


def commit_kv_windows(
    ck: torch.Tensor,  # [L, B, KH, S, D] cache K, written in place
    cv: torch.Tensor,
    upd_k: torch.Tensor,  # [L, NB, KH, T, D] per-row update windows
    upd_v: torch.Tensor,
    starts: HostInts,  # [NB] seq offset per row
    slot_idx: Optional[HostInts] = None,  # [NB] cache row per update; -1 = skip
    first: int = 0,  # the cache holds the global positions [first, first + S)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write per-row KV windows into the cache with direct indexed copies:
    row i lands at ``cache[:, slot_idx[i], :, starts[i]:starts[i]+T]``.
    Rows with slot -1 write nothing; columns past S are dropped (the start is
    never shifted). A seq rank's block (``first``): only the window's
    columns inside ``[first, first + S)``, at local indices. Returns the
    (same, updated) cache tensors."""
    s = ck.shape[3]
    t = upd_k.shape[3]
    starts = np.asarray(starts.cpu() if isinstance(starts, torch.Tensor) else starts)
    if slot_idx is None:
        slot_idx = np.arange(len(starts))
    slots = np.asarray(slot_idx.cpu() if isinstance(slot_idx, torch.Tensor) else slot_idx)
    for i, (slot, st) in enumerate(zip(slots.tolist(), starts.tolist())):
        st = max(int(st), 0)
        a, b = max(st, first), min(st + t, first + s)  # global columns written here
        if slot < 0 or b <= a:
            continue
        ck[:, slot, :, a - first:b - first] = upd_k[:, i, :, a - st:b - st]
        cv[:, slot, :, a - first:b - first] = upd_v[:, i, :, a - st:b - st]
    return ck, cv


def insert_kv(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
              slot: int, length: Optional[int] = None, first: int = 0) -> KVCache:
    """Write one prefill's K/V ([L, T, KH, D]) into slot ``slot`` at positions
    [0, T) (padding included; masked later by cache_lens); ``first``: a seq
    rank's block (``commit_kv_windows``)."""
    del length
    commit_kv_windows(cache.k, cache.v, k_new.permute(0, 2, 1, 3)[:, None],
                      v_new.permute(0, 2, 1, 3)[:, None], [0], [int(slot)], first=first)
    return cache
