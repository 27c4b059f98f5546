"""Causal flash attention over padded prompts (port of
``flexflow_tpu/ops/pallas/flash_prefill.py``; kernel ``csrc/flash_prefill.cu``).

Query position i of row b attends key positions j <= i with j < lengths[b];
f32 softmax, ``scale = 1/sqrt(D)``, GQA groups folded into the kernel's query
rows. Rows at or past their length come out as zeros (the JAX kernel lets
them attend the valid prefix instead; nothing reads those rows). The kernel
takes bf16 (tensor cores; head_dim a multiple of 16 up to 256) or float32
(the full-precision path, head_dim <= 128); the plain version takes any
float dtype. The bf16 kernel reads q/k/v in 16-byte chunks, so a view that
starts off a 16-byte boundary is copied first.
"""

from __future__ import annotations

import math

import torch

from flexflow_tpu_torch.ops.attention import NEG_INF
from flexflow_tpu_torch.ops.kernels import _build

LAUNCHES = 0


def flash_prefill_plain(q, k, v, lengths):
    """Plain PyTorch version: full masked f32 softmax per row."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, kh, h // kh, d).float()
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    pos = torch.arange(s, device=q.device)
    valid = pos[None, :] < lengths[:, None]  # [B, S]
    mask = (pos[None, :] <= pos[:, None])[None] & valid[:, None, :]  # [B, Sq, Sk]
    mask = mask[:, None, None]
    sc = torch.where(mask, sc, NEG_INF)
    m = torch.amax(sc, dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(sc - m), 0.0)
    p = e / torch.clamp_min(torch.sum(e, dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float()).reshape(b, s, h, d)
    return torch.where(valid[:, :, None, None], out, 0.0).to(q.dtype)


def flash_prefill(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, KH, D]
    v: torch.Tensor,  # [B, S, KH, D]
    lengths: torch.Tensor,  # [B] int32 valid prompt lengths
) -> torch.Tensor:
    """Returns [B, S, H, D] in q's dtype."""
    global LAUNCHES
    b, s, h, d = q.shape
    if k.dim() != 4 or k.shape[:2] != (b, s) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    kh = k.shape[2]
    if h % kh:
        raise ValueError(f"{h} heads are not a multiple of {kh} KV heads")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [{b}]")
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill runs on cuda or cpu tensors, not {q.device}")
    if any(t.device != q.device for t in (k, v, lengths)):
        raise ValueError("all inputs must be on one device")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the flash-prefill kernel takes q/k/v of one dtype: bfloat16 or float32")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    max_d = 256 if q.dtype == torch.bfloat16 else 128
    if d % 16 or d > max_d or 64 % (h // kh):
        raise ValueError(f"unsupported head_dim {d} / group size {h // kh} for {q.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, lengths)):
        raise ValueError("flash_prefill needs contiguous inputs")
    if b * s == 0:  # nothing to compute: no launch
        return torch.empty_like(q)
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    err = _build.lib().ff_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, s, h, kh, d, 1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_prefill")
    LAUNCHES += 1
    return out
