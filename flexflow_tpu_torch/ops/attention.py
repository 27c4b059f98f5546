"""Attention ops in plain PyTorch (port of ``flexflow_tpu/ops/attention.py``).

The general path (tree masks, chunked prefill, ALiBi, logit softcap) and the
oracle the two attention kernels (``ops/kernels/decode_attention.py``,
``ops/kernels/flash_prefill.py``) are held against. Softmax math is float32
with ``NEG_INF = -1e30``; scores and values are contracted in float32 after
casting the operands, the same as the JAX reference does off the TPU.

Cache layout differs from JAX: the port's per-layer cache is
``[B, KH, S, D]`` (one contiguous D-row per position) where JAX keeps
``[B, KH, D, S]`` for the TPU's (8, 128) tiling.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def alibi_slopes(num_heads: int, alibi_bias_max: float = 8.0, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes (MPT convention)."""
    n_pow2 = 2 ** math.ceil(math.log2(num_heads))
    base = torch.arange(1, n_pow2 + 1, dtype=torch.float32, device=device) * (
        alibi_bias_max / n_pow2)
    slopes = 1.0 / torch.pow(2.0, base)
    if n_pow2 != num_heads:
        slopes = torch.cat([slopes[1::2], slopes[0::2]])[:num_heads]
    return slopes


def _group_query(q: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """[..., H, D] -> [..., KH, G, D] with H = KH * G."""
    *lead, h, d = q.shape
    return q.reshape(*lead, num_kv_heads, h // num_kv_heads, d)


def _softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked fp32 softmax over the last axis; fully-masked rows yield zeros."""
    scores = torch.where(mask, scores, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(scores - m), 0.0)
    denom = torch.sum(e, dim=-1, keepdim=True)
    return e / torch.clamp_min(denom, 1e-30)


def prefill_attention(
    q: torch.Tensor,  # [S, H, D]
    k: torch.Tensor,  # [S, KH, D]
    v: torch.Tensor,  # [S, KH, D]
    *,
    length: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,  # [S]
    slopes: Optional[torch.Tensor] = None,  # [H]
    logit_softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal self-attention over one (padded) prompt. Returns [S, H, D]."""
    s, h, d = q.shape
    kh = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = _group_query(q, kh).float()  # [S, KH, G, D]
    scores = torch.einsum("qkgd,skd->kgqs", qg, k.float()) * scale
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    if slopes is not None:
        pos = q_positions if q_positions is not None else torch.arange(s, device=q.device)
        rel = pos[:, None].float() - pos[None, :].float()
        scores = scores - slopes.reshape(kh, h // kh)[:, :, None, None] * rel[None, None]
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = ki <= qi
    if length is not None:
        mask = mask & (ki < length)
    probs = _softmax(scores, mask[None, None])
    out = torch.einsum("kgqs,skd->qkgd", probs, v.float())
    return out.reshape(s, h, d).to(q.dtype)


def split_cached_attention_state(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [B, KH, S, D] committed cache, or a seq rank's slice of it
    v_cache: torch.Tensor,  # [B, KH, S, D]
    k_new: torch.Tensor,  # [B, T', KH, D] in-flight tokens' K
    v_new: torch.Tensor,  # [B, T', KH, D]
    cache_lens: torch.Tensor,  # [B] committed tokens (global count)
    *,
    new_mask: Optional[torch.Tensor] = None,  # [B, T, T'] bool; None => causal
    kv_mask: Optional[torch.Tensor] = None,  # [B, T, S] over this slice; None => committed
    q_positions: Optional[torch.Tensor] = None,  # [B, T]
    new_positions: Optional[torch.Tensor] = None,  # [B, T'] (alibi)
    slopes: Optional[torch.Tensor] = None,  # [H]
    logit_softcap: Optional[float] = None,
    scale: Optional[float] = None,
    kv_offset: int = 0,  # the slice's first global position
    with_new: bool = True,  # False: the in-flight columns are not counted here
):
    """The unnormalized softmax state of :func:`split_cached_attention` over
    a cache slice whose first position is the global ``kv_offset`` (a seq
    rank's block; positions, the committed-prefix mask and ALiBi distances
    are global). Returns ``(acc [B, T, H, D], max [B, T, H], sum [B, T,
    H])`` in f32: ``acc / sum`` is the attention output. Without
    ``with_new`` (every seq rank but the first) the in-flight columns are
    masked out, so they are counted once; a row with nothing to attend
    here gives the neutral state (acc 0, max ``NEG_INF``, sum 0)."""
    b, t, h, d = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    tn = k_new.shape[1]
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    qg = _group_query(q, kh).to(k_cache.dtype).float()  # [B, T, KH, G, D]
    sc = torch.einsum("btkgd,bksd->bkgts", qg, k_cache.float()) * scale
    sn = torch.einsum("btkgd,bukd->bkgtu", qg, k_new.to(k_cache.dtype).float()) * scale
    if logit_softcap:
        sc = torch.tanh(sc / logit_softcap) * logit_softcap
        sn = torch.tanh(sn / logit_softcap) * logit_softcap
    if slopes is not None:
        if q_positions is None:
            q_positions = cache_lens[:, None] + torch.arange(t, device=dev)[None, :]
        if new_positions is None:
            new_positions = q_positions
        kv_pos = torch.arange(kv_offset, kv_offset + s, device=dev).float()
        rel_c = q_positions[:, :, None].float() - kv_pos[None, None, :]
        rel_n = q_positions[:, :, None].float() - new_positions[:, None, :].float()
        sl = slopes.reshape(kh, h // kh)[None, :, :, None, None]
        sc = sc - sl * rel_c[:, None, None]
        sn = sn - sl * rel_n[:, None, None]

    if kv_mask is None:
        kv_pos = torch.arange(kv_offset, kv_offset + s, device=dev)[None, None, :]
        kv_mask = (kv_pos < cache_lens[:, None, None]).expand(b, t, s)
    if new_mask is None:
        new_mask = torch.tril(torch.ones(t, tn, dtype=torch.bool, device=dev))[None].expand(b, t, tn)
    if not with_new:
        new_mask = torch.zeros_like(new_mask)

    kvm = kv_mask[:, None, None]
    nm = new_mask[:, None, None]
    sc = torch.where(kvm, sc, NEG_INF)
    sn = torch.where(nm, sn, NEG_INF)
    m = torch.maximum(torch.amax(sc, dim=-1, keepdim=True),
                      torch.amax(sn, dim=-1, keepdim=True))
    ec = torch.where(kvm, torch.exp(sc - m), 0.0)
    en = torch.where(nm, torch.exp(sn - m), 0.0)
    denom = torch.sum(ec, dim=-1, keepdim=True) + torch.sum(en, dim=-1, keepdim=True)
    oc = torch.einsum("bkgts,bksd->btkgd", ec, v_cache.float())
    on = torch.einsum("bkgtu,bukd->btkgd", en, v_new.float())
    return ((oc + on).reshape(b, t, h, d), m.permute(0, 3, 1, 2, 4).reshape(b, t, h),
            denom.permute(0, 3, 1, 2, 4).reshape(b, t, h))


def pack_state(acc, m, l) -> torch.Tensor:
    """(acc [..., H, D], max [..., H], sum [..., H]) -> one f32 tensor
    [..., H, D + 2], the layout :func:`merge_states` takes."""
    return torch.cat([acc, m[..., None], l[..., None]], dim=-1)


def split_cached_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [B, KH, S, D] committed cache (read-only)
    v_cache: torch.Tensor,  # [B, KH, S, D]
    k_new: torch.Tensor,  # [B, T', KH, D] in-flight tokens' K
    v_new: torch.Tensor,  # [B, T', KH, D]
    cache_lens: torch.Tensor,  # [B]
    **kw,
) -> torch.Tensor:
    """Attention of T in-flight tokens against (read-only cache) + (new KV):
    one joint fp32 softmax over [cache | new] columns. Keywords as
    :func:`split_cached_attention_state` (``new_mask``, ``kv_mask``,
    ``q_positions``, ``new_positions``, ``slopes``, ``logit_softcap``,
    ``scale``)."""
    acc, _, denom = split_cached_attention_state(q, k_cache, v_cache, k_new, v_new,
                                                 cache_lens, **kw)
    return (acc / torch.clamp_min(denom, 1e-30)[..., None]).to(q.dtype)


def merge_states(states: torch.Tensor) -> torch.Tensor:
    """Softmax states ``[rows, H, C, D + 2]`` (each: its f32 accumulator,
    max and sum, as :func:`split_cached_attention_state` gives them; C seq
    ranks' states of one row, in rank order) merged into the attention
    output ``[rows, H, D]`` in f32: the states rescaled to their common
    maximum, accumulators and sums added, one division. Neutral states
    (max ``NEG_INF``, sum 0) add nothing."""
    acc, m, l = states[..., :-2], states[..., -2], states[..., -1]
    f = torch.exp(m - torch.amax(m, dim=-1, keepdim=True))  # [rows, H, C]
    den = torch.sum(l * f, dim=-1)
    num = torch.sum(acc * f[..., None], dim=-2)
    return num / torch.clamp_min(den, 1e-30)[..., None]


def cached_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [B, S, KH, D] (already containing the new tokens)
    v_cache: torch.Tensor,  # [B, S, KH, D]
    cache_lens: torch.Tensor,  # [B] committed tokens BEFORE this step
    *,
    tree_mask: Optional[torch.Tensor] = None,  # [B, T, T]; None => causal in T
    kv_mask: Optional[torch.Tensor] = None,  # [B, T, S] full mask override
    q_positions: Optional[torch.Tensor] = None,  # [B, T] (alibi)
    slopes: Optional[torch.Tensor] = None,  # [H]
    logit_softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of T in-flight tokens per request against a KV window that
    already holds them at ``cache_lens[b] + t`` (JAX signature and layout)."""
    b, t, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    qg = _group_query(q, kh).to(k_cache.dtype).float()
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k_cache.float()) * scale
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    if slopes is not None:
        if q_positions is None:
            q_positions = cache_lens[:, None] + torch.arange(t, device=dev)[None, :]
        kv_pos = torch.arange(s, device=dev).float()
        rel = q_positions[:, :, None].float() - kv_pos[None, None, :]
        scores = scores - slopes.reshape(kh, h // kh)[None, :, :, None, None] * rel[:, None, None]

    if kv_mask is not None:
        mask = kv_mask
    else:
        kv_pos = torch.arange(s, device=dev)[None, None, :]
        committed = (kv_pos < cache_lens[:, None, None]).expand(b, t, s)
        if tree_mask is None:
            tree_mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=dev))[None].expand(b, t, t)
        inflight_slot = cache_lens[:, None] + torch.arange(t, device=dev)[None, :]  # [B, T']
        eq = torch.arange(s, device=dev)[None, None, :, None] == inflight_slot[:, None, None, :]
        inflight = torch.any(eq & tree_mask[:, :, None, :], dim=-1)  # [B, T, S]
        mask = committed | inflight

    probs = _softmax(scores, mask[:, None, None])
    out = torch.einsum("bkgts,bskd->btkgd", probs, v_cache.float())
    return out.reshape(b, t, h, d).to(q.dtype)
