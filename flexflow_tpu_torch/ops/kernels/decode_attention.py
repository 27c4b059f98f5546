"""Decode attention: one query token per slot (port of
``flexflow_tpu/ops/pallas/decode_attention.py``; kernel
``csrc/decode_attention.cu``), and the same kernel over a token tree.

``decode_attention``: softmax over the committed cache positions
``< cache_lens[b]`` plus the token's own K/V (not yet in the cache), f32,
``scale = 1/sqrt(D)``. The cache is the port's ``[B, KH, S, D]`` layout.
G = H / KH may be 1 (MHA), a GQA group or all heads (MQA).

``tree_attention``: T in-flight tokens per slot under a [B, T, T] mask (tree
verification): each token attends the committed positions, the in-flight
tokens its mask row names, in ascending order, and itself where the diagonal
says so. Along a tree path the kernel repeats, bit for bit, the arithmetic of
``decode_attention`` after the path's tokens were committed one by one, so a
tree-verified token gets incremental decoding's bits. The JAX package leaves
this masked attention to XLA; here it is the kernel's second form.

On the card a call launches two kernels (``csrc/decode_attention.cu``): one
block per (chunk of ``CHUNK`` virtual positions, KV head, slot) writes the
partial softmax state of each query row it holds (the slot's token, or its
tree's nodes) to a workspace, and a second kernel merges a row's chunks in
chunk order. The chunk count and the workspace's shape come from the shapes
alone (:func:`plan`): no call reads ``cache_lens`` on the host.

The shard form (context parallelism: a seq rank's block of the cache's
positions, ``first`` its first global position): ``decode_attention_state``
and ``tree_attention_state`` run the same two kernels over the block, with
the rank's committed count computed on the device, the in-flight items
joining only where ``inflight`` (seq rank 0), and return each row's
unnormalized f32 state ``[..., H, D + 2]`` (accumulator, max, sum);
``merge_states`` merges C ranks' states ``[rows, H, C, D + 2]`` in rank
order with the merge kernel (a third entry point) into the output. Each
has its plain version beside it (``*_plain``), taken only for a CPU
tensor; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from flexflow_tpu_torch.ops import attention as attn_lib
from flexflow_tpu_torch.ops.attention import NEG_INF, split_cached_attention
from flexflow_tpu_torch.ops.kernels import _build

LAUNCHES = 0  # calls that launched the kernels, both forms (two kernels a call)
SHARD_LAUNCHES = 0  # shard-form calls that launched them, both forms (two kernels a call)
MERGE_LAUNCHES = 0  # merge_states calls that launched the merge kernel
_HEAD_DIMS = (32, 64, 96, 128, 160, 192, 256)
# virtual positions a block attends: the C side refuses any other value
CHUNK = 64


def plan(q: torch.Tensor, k_cache: torch.Tensor):
    """(chunks per row, workspace shape) of a launch, from the shapes of q
    ([B, H, D], or [B, T, H, D] for the tree form) and the cache [B, KH, S, D]
    alone. A row's virtual positions are its committed ones, at most T - 1
    in-flight ancestors and the token itself: at most S + T of them. The
    workspace holds, for each (query row, head, chunk), the chunk's f32
    accumulator [D] then its running max and sum."""
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    nt = q.shape[1] if q.dim() == 4 else 1
    chunks = -(-(k_cache.shape[2] + nt) // CHUNK)
    return chunks, (b * nt, h, chunks, d + 2)


def decode_attention_plain(q, k_cache, v_cache, k_self, v_self, cache_lens):
    """Plain PyTorch version (f32 math, output in q's dtype)."""
    b, h, d = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kh, h // kh, d).float()
    sc = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * scale
    mask = (torch.arange(s, device=q.device)[None, :] < cache_lens[:, None])[:, None, None]
    sc = torch.where(mask, sc, NEG_INF)
    s_self = torch.einsum("bkgd,bkd->bkg", qg, k_self.float())[..., None] * scale
    m = torch.maximum(torch.amax(sc, dim=-1, keepdim=True), s_self)
    e = torch.where(mask, torch.exp(sc - m), 0.0)
    e_self = torch.exp(s_self - m)
    denom = torch.sum(e, dim=-1, keepdim=True) + e_self
    out = (torch.einsum("bkgs,bksd->bkgd", e, v_cache.float())
           + e_self * v_self.float()[:, :, None, :]) / torch.clamp_min(denom, 1e-30)
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [B, KH, S, D] committed cache (token not written)
    v_cache: torch.Tensor,  # [B, KH, S, D]
    k_self: torch.Tensor,  # [B, KH, D] this token's K (cache dtype)
    v_self: torch.Tensor,  # [B, KH, D]
    cache_lens: torch.Tensor,  # [B] int32, each in [0, S]
) -> torch.Tensor:
    """Returns [B, H, D] in q's dtype."""
    global LAUNCHES
    _check_one(q, k_cache, v_cache, k_self, v_self, cache_lens)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, k_self, v_self, cache_lens)
    out = _launch("decode_attention", q, k_cache, v_cache, k_self, v_self, cache_lens, None, 1)
    LAUNCHES += 1
    return out


def _check_one(q, k_cache, v_cache, k_self, v_self, cache_lens) -> None:
    """The one-token form's shape checks."""
    b, h, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    kh = k_cache.shape[1]
    if h % kh or v_cache.shape != k_cache.shape:
        raise ValueError("heads / cache shapes are inconsistent")
    if k_self.shape != (b, kh, d) or v_self.shape != (b, kh, d):
        raise ValueError(f"k_self/v_self must be {(b, kh, d)}")
    if cache_lens.shape != (b,):
        raise ValueError(f"cache_lens must be [{b}]")


def _check_tree(q, k_cache, v_cache, k_new, v_new, cache_lens, tree_mask) -> None:
    """The tree form's shape checks."""
    b, t, h, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    kh = k_cache.shape[1]
    if h % kh or v_cache.shape != k_cache.shape:
        raise ValueError("heads / cache shapes are inconsistent")
    if k_new.shape != (b, t, kh, d) or v_new.shape != (b, t, kh, d):
        raise ValueError(f"k_new/v_new must be {(b, t, kh, d)}")
    if tree_mask.shape != (b, t, t) or cache_lens.shape != (b,):
        raise ValueError(f"tree_mask must be {(b, t, t)} and cache_lens [{b}]")


def tree_index(tree_mask: torch.Tensor):
    """The tree form's per-token inputs from a [B, T, T] mask: the in-flight
    columns each token attends besides itself, ascending ([B, T, T] int32,
    the first ``count`` valid), their count ([B, T] int32) and whether it
    attends itself ([B, T] int32). Computed on the mask's device, no host
    sync; one per forward, shared by every layer."""
    t = tree_mask.shape[-1]
    cols = torch.arange(t, device=tree_mask.device)
    strict = tree_mask & (cols[:, None] != cols[None, :])
    idx = torch.argsort(torch.where(strict, cols, cols + t), dim=-1).to(torch.int32)
    return (idx.contiguous(), strict.sum(-1, dtype=torch.int32).contiguous(),
            tree_mask.diagonal(dim1=1, dim2=2).to(torch.int32).contiguous())


def tree_attention_plain(q, k_cache, v_cache, k_new, v_new, cache_lens, tree_mask):
    """Plain PyTorch version: the joint f32 softmax over the committed cache
    and the masked in-flight tokens (``ops.attention.split_cached_attention``)."""
    return split_cached_attention(q, k_cache, v_cache, k_new, v_new, cache_lens,
                                  new_mask=tree_mask)


def tree_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [B, KH, S, D] committed cache (read-only)
    v_cache: torch.Tensor,  # [B, KH, S, D]
    k_new: torch.Tensor,  # [B, T, KH, D] the in-flight tokens' K (cache dtype)
    v_new: torch.Tensor,  # [B, T, KH, D]
    cache_lens: torch.Tensor,  # [B] int32
    tree_mask: torch.Tensor,  # [B, T, T] bool: token t attends in-flight u
    index=None,  # tree_index(tree_mask), when the caller already has it
) -> torch.Tensor:
    """Returns [B, T, H, D] in q's dtype."""
    global LAUNCHES
    _check_tree(q, k_cache, v_cache, k_new, v_new, cache_lens, tree_mask)
    if q.device.type == "cpu":
        return tree_attention_plain(q, k_cache, v_cache, k_new, v_new, cache_lens, tree_mask)
    index = tree_index(tree_mask) if index is None else index
    out = _launch("tree_attention", q, k_cache, v_cache, k_new, v_new, cache_lens, index,
                  q.shape[1])
    LAUNCHES += 1
    return out


def tree_attention_state_plain(q, k_cache, v_cache, k_new, v_new, cache_lens, tree_mask, *,
                               first: int, inflight: bool):
    """Plain PyTorch version of :func:`tree_attention_state`
    (``ops.attention.split_cached_attention_state`` on the block)."""
    return attn_lib.pack_state(*attn_lib.split_cached_attention_state(
        q, k_cache, v_cache, k_new, v_new, cache_lens, new_mask=tree_mask, kv_offset=first,
        with_new=inflight))


def decode_attention_state_plain(q, k_cache, v_cache, k_self, v_self, cache_lens, *,
                                 first: int, inflight: bool):
    """Plain PyTorch version of :func:`decode_attention_state`."""
    return tree_attention_state_plain(q[:, None], k_cache, v_cache, k_self[:, None],
                                      v_self[:, None], cache_lens, None, first=first,
                                      inflight=inflight)[:, 0]


def decode_attention_state(q, k_cache, v_cache, k_self, v_self, cache_lens, *, first: int,
                           inflight: bool) -> torch.Tensor:
    """:func:`decode_attention` over a seq rank's block of the cache (the
    global positions ``[first, first + S)``; ``cache_lens`` global), the
    token's own K/V joining where ``inflight``. Returns the rows' f32 states
    [B, H, D + 2] (accumulator, max, sum)."""
    global SHARD_LAUNCHES
    _check_one(q, k_cache, v_cache, k_self, v_self, cache_lens)
    if q.device.type == "cpu":
        return decode_attention_state_plain(q, k_cache, v_cache, k_self, v_self, cache_lens,
                                            first=first, inflight=inflight)
    out = _launch("decode_attention_state", q, k_cache, v_cache, k_self, v_self, cache_lens,
                  None, 1, shard=(int(first), bool(inflight)))
    SHARD_LAUNCHES += 1
    return out


def tree_attention_state(q, k_cache, v_cache, k_new, v_new, cache_lens, tree_mask, *,
                         first: int, inflight: bool, index=None) -> torch.Tensor:
    """:func:`tree_attention` over a seq rank's block of the cache, as
    :func:`decode_attention_state`. Returns [B, T, H, D + 2] f32 states."""
    global SHARD_LAUNCHES
    _check_tree(q, k_cache, v_cache, k_new, v_new, cache_lens, tree_mask)
    if q.device.type == "cpu":
        return tree_attention_state_plain(q, k_cache, v_cache, k_new, v_new, cache_lens,
                                          tree_mask, first=first, inflight=inflight)
    index = tree_index(tree_mask) if index is None else index
    out = _launch("tree_attention_state", q, k_cache, v_cache, k_new, v_new, cache_lens, index,
                  q.shape[1], shard=(int(first), bool(inflight)))
    SHARD_LAUNCHES += 1
    return out


def merge_states_plain(states: torch.Tensor, dtype) -> torch.Tensor:
    """Plain PyTorch version of :func:`merge_states`
    (``ops.attention.merge_states``)."""
    return attn_lib.merge_states(states).to(dtype)


def merge_states(states: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """C seq ranks' f32 states [rows, H, C, D + 2] of each row, in rank
    order, merged into the attention output [rows, H, D] in ``dtype``
    (bfloat16 or float32) by the merge kernel: the states rescaled to their
    common maximum and summed in rank order, then one division."""
    global MERGE_LAUNCHES
    if states.dim() != 4 or states.dtype != torch.float32:
        raise ValueError(f"states must be f32 [rows, H, C, D + 2], got {tuple(states.shape)} "
                         f"{states.dtype}")
    if states.device.type == "cpu":
        return merge_states_plain(states, dtype)
    if states.device.type != "cuda":
        raise ValueError(f"merge_states runs on cuda or cpu tensors, not {states.device}")
    rows, h, c, d = states.shape[0], states.shape[1], states.shape[2], states.shape[3] - 2
    if d not in _HEAD_DIMS or dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"merge_states: head_dim {d} not in {_HEAD_DIMS} or dtype {dtype}")
    states = states.contiguous()
    out = torch.empty((rows, h, d), dtype=dtype, device=states.device)
    err = _build.lib().ff_merge_states(states.data_ptr(), out.data_ptr(), rows, h, c, d,
                                       int(dtype == torch.bfloat16),
                                       _build.stream_ptr(states.device))
    _build.check(err, "merge_states")
    MERGE_LAUNCHES += 1
    return out


def _launch(name, q, k_cache, v_cache, k_new, v_new, cache_lens, index, nt, shard=None):
    """Checks for a CUDA launch of either form, then the launch; ``shard``
    (first position, in-flight flag): the shard form, returning the rows'
    f32 states."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {q.device}")
    tensors = (q, k_cache, v_cache, k_new, v_new)
    extra = tuple(index or ())
    if any(x.device != q.device for x in (*tensors, cache_lens, *extra)):
        raise ValueError(f"{name}: all inputs must be on one device")
    if q.dtype not in (torch.bfloat16, torch.float32) or any(x.dtype != q.dtype for x in tensors):
        raise TypeError(f"{name}: q, caches and new K/V must share one dtype: "
                        "bfloat16 or float32")
    if any(x.dtype != torch.int32 for x in (cache_lens, *extra)):
        raise TypeError(f"{name}: cache_lens and the tree index must be int32")
    d = q.shape[-1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    if not all(x.is_contiguous() for x in (*tensors, cache_lens, *extra)):
        raise ValueError(f"{name} needs contiguous inputs")
    b, kh, s = k_cache.shape[0], k_cache.shape[1], k_cache.shape[2]
    h = q.shape[-2]
    # 16-byte copies: a view that starts off a 16-byte boundary is copied
    q, k_cache, v_cache, k_new, v_new = (x if x.data_ptr() % 16 == 0 else x.clone()
                                         for x in tensors)
    _, ws_shape = plan(q, k_cache)
    ws = torch.empty(ws_shape, dtype=torch.float32, device=q.device)
    ptrs = [x.data_ptr() for x in extra] if extra else [None, None, None]
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), cache_lens.data_ptr(), *ptrs)
    tail = (b, nt, h, kh, s, d, CHUNK, 1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16))
    if shard is None:
        out = torch.empty_like(q)
        err = _build.lib().ff_decode_attention(*args, out.data_ptr(), ws.data_ptr(), *tail,
                                               _build.stream_ptr(q.device))
    else:
        out = torch.empty((*q.shape[:-1], d + 2), dtype=torch.float32, device=q.device)
        err = _build.lib().ff_decode_attention_shard(*args, out.data_ptr(), ws.data_ptr(),
                                                     *tail, shard[0], int(shard[1]),
                                                     _build.stream_ptr(q.device))
    _build.check(err, name)
    return out
