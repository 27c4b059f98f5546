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

CPU offload (JAX ``_stream_in``): ``params["layers"]`` may be a
:class:`~flexflow_tpu_torch.models.layer_store.LayerStore` (layers in pinned
host memory, two device slots) instead of the stacked dict. Both forwards
then read layer i from its staged slot (plain leaves at index 0, quantized
ones as ``LayerQuant(slot, 0)``) and release it after the layer, so dense,
MoE and LoRA layers, prefill, chunked prefill and decode all stream.

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
    tree_attention,
    tree_index,
)
from flexflow_tpu_torch.ops.kernels.flash_prefill import flash_prefill
from flexflow_tpu_torch.ops.kernels.quant_matmul import LayerQuant, quant_matmul
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
                  dtype=torch.bfloat16, device="cpu") -> KVCache:
    shape = (spec.num_layers, num_slots, spec.num_kv_heads, max_seq_len, spec.head_dim)
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


def _linear(x, w, b=None):
    """x [..., D] @ w [D, ...out] (+ b); quantized weights go to the kernel."""
    if isinstance(w, LayerQuant):
        out = quant_matmul(x, w.qa, layer=w.layer)
    elif isinstance(w, QuantizedArray):
        out = quant_matmul(x, w)
    else:
        out = torch.tensordot(x, w, dims=1)
    if b is not None:
        out = out + b
    return out.to(x.dtype)


def _apply_lora(p: Params, mod: str, x, out):
    """``out`` plus module ``mod``'s routed LoRA delta: ``x @ a`` over every
    adapter, weighted by the scale on each row's own adapter and by 0 on
    the others, ``@ b``, in float32, cast once to ``out``'s dtype. Rows
    routed to -1 keep ``out`` bit for bit. ``p["_lora"]`` holds the layer's
    (a [D_in, N*r], b [N*r, D_out]) per module (keyed by module name: fused
    carriers hold no wq...wu)."""
    lora = p.get("_lora")
    if lora is None or mod not in lora:
        return out
    a, b = lora[mod]
    bsz = out.shape[0]
    xa = torch.matmul(x.reshape(bsz, -1, a.shape[0]).float(), a) * p["_lora_weight"]
    delta = torch.matmul(xa, b).reshape(out.shape).to(out.dtype)
    keep = p["_lora_keep"].reshape((bsz,) + (1,) * (out.dim() - 1))
    return torch.where(keep, out + delta, out)


def _qkv(spec: ModelSpec, p: Params, h):
    """h [B,T,D] -> q [B,T,H,Dh], k/v [B,T,KH,Dh]."""
    if "wqkv" in p:
        out = _linear(h, p["wqkv"], p.get("bqkv"))
        hh, kh = spec.num_heads, spec.num_kv_heads
        q, k, v = torch.split(out, [hh, kh, kh], dim=-2)
    else:
        q, k, v = (_linear(h, p["wq"], p.get("bq")), _linear(h, p["wk"], p.get("bk")),
                   _linear(h, p["wv"], p.get("bv")))
    hf = h.float() if "_lora" in p else h  # one cast for the three deltas
    return _apply_lora(p, "wq", hf, q), _apply_lora(p, "wk", hf, k), _apply_lora(p, "wv", hf, v)


def fuse_qkv_params(spec: ModelSpec, params: Params) -> Params:
    """Concatenate wq|wk|wv into ``wqkv`` [L, D, H+2KH, Dh] and wg|wu into
    ``wgu`` [L, D, 2F] so a step pays one kernel call per group. Column-exact
    (quantized groups included, via ``concat_rest``)."""
    layers = dict(params["layers"])
    hh, kh = spec.num_heads, spec.num_kv_heads

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
                layers["wgu"] = concat_rest(ws, (2 * spec.intermediate_size,))
            else:
                layers["wgu"] = torch.cat(ws, dim=-1)
            for n in ("wg", "wu"):
                layers.pop(n, None)
    return {**params, "layers": layers}


def _moe_mlp(spec: ModelSpec, p: Params, h, valid=None):
    """Mixtral's sparse MoE FFN (JAX ``_moe_mlp``): an f32 router, then the
    dense or the ragged form of ``ops/moe.py``. ``valid`` [B, T] marks the
    rows the ragged form computes (None: every row)."""
    b, t, d = h.shape
    x = h.reshape(b * t, d)
    # every row through the router in both forms, so a row's routing never
    # depends on which rows the ragged form keeps (nor on the row count)
    router_logits = moe_lib.router_logits(x, p["router"])  # [N, E]
    rows = None
    if spec.moe.impl == "ragged" and valid is not None:
        rows = valid.reshape(-1).nonzero()[:, 0]
        x, router_logits = x[rows], router_logits[rows]
    ffn = moe_lib.moe_ffn_ragged if spec.moe.impl == "ragged" else moe_lib.moe_ffn_dense
    out = ffn(x, router_logits, p["wg"], p["wu"], p["wd"], spec.moe.top_k)
    if rows is not None:
        out = torch.zeros_like(h).reshape(b * t, d).index_copy_(0, rows, out)
    return out.reshape(b, t, d)


def _mlp(spec: ModelSpec, p: Params, h, valid=None):
    if spec.moe is not None:
        return _moe_mlp(spec, p, h, valid)
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
    out = _linear(inner, p["wd"])
    if p.get("bd") is not None:
        out = out + p["bd"]
    return _apply_lora(p, "wd", inner, out.to(h.dtype))


def _attn_out(spec: ModelSpec, p: Params, a):
    """a [B,T,H,Dh] -> [B,T,D] via wo [H,Dh,D]."""
    wo = p["wo"]
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


def _layer_views(spec: ModelSpec, params: Params, lora: Optional[RoutedLora],
                 routing: Optional[Params]) -> Iterator[Tuple[int, Params]]:
    """(i, layer i's parameters) in layer order, with the layer's adapter
    weights and the routing when the forward has LoRA. From a
    :class:`LayerStore` (CPU offload) layer i is read from its staged slot
    and released once the caller's work on it is enqueued, which starts the
    copy of layer i + 2 into that slot."""
    layers = params["layers"]
    store = layers if isinstance(layers, LayerStore) else None
    for i in range(spec.num_layers):
        p = store.acquire(i) if store is not None else _layer_params(layers, i)
        if routing is not None:
            p.update(routing, _lora={m: (lora.a[m][i], lora.b[m][i]) for m in lora.a})
        yield i, p
        if store is not None:
            store.release(i)


def _embed(spec: ModelSpec, params: Params, tokens, positions):
    h = params["embed_tokens"][tokens.long()]
    if spec.embed_scale != 1.0:
        h = h * spec.embed_scale
    if spec.pos == "learned":
        h = h + params["embed_pos"][(positions + spec.learned_pos_offset).long()]
    return h


def _unembed(spec: ModelSpec, params: Params, h):
    """h [..., D] -> f32 logits [..., V]."""
    if spec.final_norm:
        h = _norm(spec, h, params["final_norm_scale"], params.get("final_norm_bias"))
    w = params.get("lm_head")
    if isinstance(w, QuantizedArray):
        logits = quant_matmul(h, w, out_dtype=torch.float32)
    else:
        w = params["embed_tokens"].T if w is None else w  # tied
        logits = torch.tensordot(h.float(), w.float(), dims=1)
    if params.get("lm_head_bias") is not None:
        logits = logits + params["lm_head_bias"].float()
    return logits


def _alibi_slopes(spec: ModelSpec, device):
    if spec.pos != "alibi":
        return None
    return attn_lib.alibi_slopes(spec.num_heads, spec.alibi_max_bias, device)


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
    """
    b, t = tokens.shape
    dev = tokens.device
    slopes = _alibi_slopes(spec, dev)
    h = _embed(spec, params, tokens, positions)
    if traces is not None:
        traces["embed_tokens.output"] = h
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
            traces.update({f"layers.{i}.q_proj": q, f"layers.{i}.k_proj": k,
                           f"layers.{i}.v_proj": v})
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
            traces[f"layers.{i}.attn_output"] = out
        return out

    ks, vs = [], []
    for i, p in _layer_views(spec, params, lora, routing):
        kvs = []
        h = _layer(spec, p, h, attend, valid)
        if traces is not None:
            traces[f"layers.{i}.output"] = h
        (k, v), = kvs
        if kv_sink is not None:
            kv_sink(i, k, v)
        if return_kv:
            ks.append(k)
            vs.append(v)
    if logits_at is not None:
        h = _gather_rows(h, logits_at)
    logits = _unembed(spec, params, h)
    if traces is not None:
        traces["lm_head.output"] = logits
    return logits, ((torch.stack(ks), torch.stack(vs)) if return_kv else None)


def _window_index(starts: HostInts, t: int, s: int, device):
    """Host-side (slot, position, update-row) indices of the in-range columns
    of windows [starts[b], starts[b] + t), clipped at S; None if empty."""
    st = np.clip(np.asarray(starts, dtype=np.int64), 0, s)
    pos = st[:, None] + np.arange(t)[None, :]
    bi, ti = np.nonzero(pos < s)
    if bi.size == 0:
        return None
    return tuple(to_device(a, device, np.int64) for a in (bi, pos[bi, ti], ti))


def device_window(cache_lens: torch.Tensor, t: int, s: int):
    """Device-side indices of the windows [lens[b], lens[b] + t) of a cache of
    S positions, with no host read: (slot [B, t], position [B, t], keep
    [B, t]). A column at or past S is not kept and is aimed at lens[b] - 1,
    which no kept column of its row targets, so writing the old value back
    there drops it. Needs t <= S."""
    if t > s:
        raise ValueError(f"a window of {t} columns does not fit a cache of {s} positions")
    lens = cache_lens.long()[:, None]
    pos = lens + torch.arange(t, device=cache_lens.device)[None, :]
    keep = pos < s
    safe = torch.where(keep, pos, (lens - 1).clamp(0, s - 1))
    slots = torch.arange(cache_lens.shape[0], device=cache_lens.device)[:, None].expand(-1, t)
    return slots, safe, keep


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
    """
    b, t = tokens.shape
    dev = tokens.device
    s = cache.max_seq_len
    slopes = _alibi_slopes(spec, dev)
    cache_lens = cache_lens.to(device=dev, dtype=torch.int32)
    if positions is None:
        positions = cache_lens[:, None] + torch.arange(t, device=dev, dtype=torch.int32)[None, :]
    h = _embed(spec, params, tokens, positions)

    if write_cache:
        if write_start is None:
            dwin = device_window(cache_lens, t, s)
        else:
            widx = _window_index(write_start, t, s, dev)
    window = attn_window if attn_window is not None and attn_window < s else s
    if kv_mask is not None:
        kv_mask = kv_mask[..., :window]
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

    new_k, new_v = [], []
    for i, p in _layer_views(spec, params, lora, routing):
        ck_l, cv_l = cache.k[i], cache.v[i]  # [B, KH, S, D]

        def attend(q, k, v):
            q, k = _maybe_rope(q, k, rope)
            # cast once to the cache dtype so attention sees exactly what a
            # later step reads back from the cache
            kc, vc = k.to(ck_l.dtype), v.to(cv_l.dtype)
            if use_kernel and tree_mask is not None:
                out = tree_attention(q.contiguous(), ck_l, cv_l, kc.contiguous(),
                                     vc.contiguous(), cache_lens, tree_mask, index=tidx)
            elif use_kernel:
                out = decode_attention(q[:, 0].contiguous(), ck_l, cv_l,
                                       kc[:, 0].contiguous(), vc[:, 0].contiguous(),
                                       cache_lens)[:, None]
            else:
                kn, vn = kc, vc
                if extra_kv is not None:
                    kn = torch.cat([extra_kv[0][i].to(kc.dtype), kc], dim=1)
                    vn = torch.cat([extra_kv[1][i].to(vc.dtype), vc], dim=1)
                out = attn_lib.split_cached_attention(
                    q, ck_l[:, :, :window], cv_l[:, :, :window], kn, vn, cache_lens,
                    new_mask=joint_mask, kv_mask=kv_mask, q_positions=positions,
                    new_positions=joint_positions, slopes=slopes,
                    logit_softcap=spec.attn_logit_softcap)
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
    logits = _unembed(spec, params, h)
    if not write_cache:
        return logits, (torch.stack(new_k), torch.stack(new_v))
    return logits, cache


def commit_kv_windows(
    ck: torch.Tensor,  # [L, B, KH, S, D] cache K, written in place
    cv: torch.Tensor,
    upd_k: torch.Tensor,  # [L, NB, KH, T, D] per-row update windows
    upd_v: torch.Tensor,
    starts: HostInts,  # [NB] seq offset per row
    slot_idx: Optional[HostInts] = None,  # [NB] cache row per update; -1 = skip
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write per-row KV windows into the cache with direct indexed copies:
    row i lands at ``cache[:, slot_idx[i], :, starts[i]:starts[i]+T]``.
    Rows with slot -1 write nothing; columns past S are dropped (the start is
    never shifted). Returns the (same, updated) cache tensors."""
    s = ck.shape[3]
    t = upd_k.shape[3]
    starts = np.asarray(starts.cpu() if isinstance(starts, torch.Tensor) else starts)
    if slot_idx is None:
        slot_idx = np.arange(len(starts))
    slots = np.asarray(slot_idx.cpu() if isinstance(slot_idx, torch.Tensor) else slot_idx)
    for i, (slot, st) in enumerate(zip(slots.tolist(), starts.tolist())):
        st = min(max(int(st), 0), s)
        n = min(t, s - st)
        if slot < 0 or n <= 0:
            continue
        ck[:, slot, :, st:st + n] = upd_k[:, i, :, :n]
        cv[:, slot, :, st:st + n] = upd_v[:, i, :, :n]
    return ck, cv


def insert_kv(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
              slot: int, length: Optional[int] = None) -> KVCache:
    """Write one prefill's K/V ([L, T, KH, D]) into slot ``slot`` at positions
    [0, T) (padding included; masked later by cache_lens)."""
    del length
    commit_kv_windows(cache.k, cache.v, k_new.permute(0, 2, 1, 3)[:, None],
                      v_new.permute(0, 2, 1, 3)[:, None], [0], [int(slot)])
    return cache
