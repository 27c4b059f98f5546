"""Ring attention and context-parallel decode attention over the mesh's
``seq`` axis (port of ``flexflow_tpu/ops/ring_attention.py``), in plain
PyTorch as JAX's are ``jnp`` / ``lax``.

- :func:`ring_prefill_attention`: causal attention of a seq rank's block
  of queries ``[S_loc, H, D]``. Each rank holds its K/V block, attends it
  under an f32 online softmax, and passes it to the next seq rank
  (``parallel/mesh.Mesh.ring_send`` / ``ring_recv``: rank ``c`` to ``c +
  1``), so after t rotations rank ``c`` holds block ``(c - t) mod C``, as
  JAX's ``_ring_perm`` rotates them; after C blocks every query has seen
  every key. :func:`context_parallel_prefill` takes the global tensors,
  runs the rank's block and gathers the output (JAX's ``shard_map``
  wrapper).
- :func:`cp_cached_attention`: decode / tree-verify attention over a seq
  rank's slice ``[B, KH, S_loc, D]`` of the cache (the port's layout).
  Each rank computes the softmax state of its slice, the in-flight tokens
  counted on seq rank 0 only, and the C states are gathered over ``seq``
  and merged (``ops/attention.merge_states``), where JAX merges with one
  ``pmax`` and two ``psum``s. :func:`context_parallel_decode` takes the
  global cache.

The ring prefill is not on the serving path (JAX's engines neither: their
prefill is replicated over ``seq``); the served decode runs the decoder's
seq path (``models/decoder.forward_cached`` under ``Shard.seq``), whose
kernel is the decode-attention kernel's shard form. Every function here
takes the mesh (a ``parallel/mesh.Mesh`` with ``seq > 1``) and every seq
rank calls it with the same arguments.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from flexflow_tpu_torch.ops.attention import (NEG_INF, _group_query, merge_states,
                                              pack_state, split_cached_attention_state)

SEQ_AXIS = "seq"  # parallel.mesh.SEQ_AXIS
_TINY = 1e-30


def ring_prefill_attention(
    q: torch.Tensor,  # [S_loc, H, D] this seq rank's block of queries
    k: torch.Tensor,  # [S_loc, KH, D] its block of keys
    v: torch.Tensor,  # [S_loc, KH, D]
    mesh,
    *,
    length: Optional[int] = None,  # valid prompt length (global)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal ring attention of the rank's block (global positions ``[c
    S_loc, (c + 1) S_loc)``): ``attention.prefill_attention`` on the whole
    sequence, this block's rows. Returns [S_loc, H, D] in q's dtype; rows
    with nothing to attend are zero."""
    s_loc, h, d = q.shape
    kh = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n, idx = mesh.seq, mesh.seq_rank
    dev = q.device
    # [KH, G, S, D]: the queries stay put through every ring step
    qg = _group_query(q, kh).float().permute(1, 2, 0, 3)
    q_pos = idx * s_loc + torch.arange(s_loc, device=dev)
    o = torch.zeros((kh, h // kh, s_loc, d), dtype=torch.float32, device=dev)
    m = torch.full((kh, h // kh, s_loc, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    k_blk, v_blk = k.contiguous(), v.contiguous()
    for t in range(n):
        src = (idx - t) % n  # the global block this rank holds now
        k_pos = src * s_loc + torch.arange(s_loc, device=dev)
        scores = torch.einsum("kgqd,skd->kgqs", qg, k_blk.float()) * scale
        mask = k_pos[None, :] <= q_pos[:, None]
        if length is not None:
            mask = mask & (k_pos[None, :] < length)
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, torch.amax(scores, dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(scores - m_new), 0.0)
        l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
        o = o * alpha + torch.einsum("kgqs,skd->kgqd", p, v_blk.float())
        m = m_new
        if t + 1 < n:  # the last block needs no rotation
            mesh.ring_send(k_blk)
            mesh.ring_send(v_blk)
            k_blk, v_blk = mesh.ring_recv(k_blk), mesh.ring_recv(v_blk)
            mesh.wait_sends()
    out = o / torch.clamp_min(l, _TINY)
    return out.permute(2, 0, 1, 3).reshape(s_loc, h, d).to(q.dtype)


def gather_states(state: torch.Tensor, mesh) -> torch.Tensor:
    """Every seq rank's softmax states [B, T, H, D + 2] (this rank's given),
    gathered in rank order: [B * T, H, C, D + 2], the layout the merge
    takes."""
    b, t, h, d2 = state.shape
    return mesh.all_gather(state[..., None, :], 3, SEQ_AXIS).reshape(b * t, h, -1, d2)


def _block(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The seq rank's block of ``x`` along ``dim`` (equal blocks)."""
    n = x.shape[dim]
    if n % mesh.seq:
        raise ValueError(f"an axis of {n} does not divide over {mesh.seq} seq ranks")
    w = n // mesh.seq
    return x.narrow(dim, mesh.seq_rank * w, w).contiguous()


def context_parallel_prefill(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             length: Optional[int] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """The ring prefill over the global ``q`` [S, H, D], ``k`` / ``v`` [S,
    KH, D]: each seq rank runs its block, and the blocks are gathered in
    rank order. Returns [S, H, D] on every rank."""
    out = ring_prefill_attention(_block(q, mesh, 0), _block(k, mesh, 0), _block(v, mesh, 0),
                                 mesh, length=length, scale=scale)
    return mesh.all_gather(out, 0, SEQ_AXIS)


def cp_cached_attention(
    q: torch.Tensor,  # [B, T, H, D] (the same on every seq rank)
    k_cache: torch.Tensor,  # [B, KH, S_loc, D] this seq rank's slice of the cache
    v_cache: torch.Tensor,  # [B, KH, S_loc, D]
    k_new: torch.Tensor,  # [B, T', KH, D] this step's K
    v_new: torch.Tensor,  # [B, T', KH, D]
    cache_lens: torch.Tensor,  # [B] committed tokens (global count)
    mesh,
    *,
    new_mask: Optional[torch.Tensor] = None,  # [B, T, T'] bool; None => causal
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode / tree-verify attention over a seq-cut cache: seq rank ``c``
    holds the global positions ``[c S_loc, (c + 1) S_loc)``. Each rank's
    softmax state over its slice (the in-flight columns on rank 0 only),
    gathered over ``seq`` and merged in rank order: ``attention.
    split_cached_attention`` up to f32 summation order, the same bits on
    every rank. Returns [B, T, H, D] in q's dtype."""
    state = pack_state(*split_cached_attention_state(
        q, k_cache, v_cache, k_new, v_new, cache_lens, new_mask=new_mask, scale=scale,
        kv_offset=mesh.seq_rank * k_cache.shape[2], with_new=mesh.seq_rank == 0))
    return merge_states(gather_states(state, mesh)).reshape(q.shape).to(q.dtype)


def context_parallel_decode(mesh, q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                            cache_lens: torch.Tensor, *,
                            new_mask: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """:func:`cp_cached_attention` over the global cache [B, KH, S, D]: each
    seq rank takes its slice of positions. Returns [B, T, H, D] on every
    rank."""
    return cp_cached_attention(q, _block(k_cache, mesh, 2), _block(v_cache, mesh, 2), k_new,
                               v_new, cache_lens, mesh, new_mask=new_mask, scale=scale)
