"""Token sampling: greedy argmax, temperature, top-k, top-p (port of
``flexflow_tpu/ops/sampling.py``).

``jax.random`` keys become integer seeds. A step's key is one 63-bit integer
drawn from the scheduler's ``torch.Generator``; row ``r`` draws from a
generator seeded with ``fold_in(key, rows[r])``, its global row, so a
request's sampled stream depends only on (key, global row), never on the
batch around it. The
bits differ from ``jax.random``'s; parity with JAX is the exact filtered
logits plus the distribution.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flexflow_tpu_torch.ops.topk import top_k

_MASK64 = (1 << 64) - 1


class SamplingConfig(NamedTuple):
    """Per-slot sampling parameters, shape [B] each."""

    temperature: torch.Tensor  # f32; <= 0 means greedy
    top_p: torch.Tensor  # f32 in (0, 1]; 1.0 disables
    top_k: torch.Tensor  # int32; 0 disables

    @staticmethod
    def greedy(batch: int, device=None) -> "SamplingConfig":
        return SamplingConfig(
            temperature=torch.zeros(batch, dtype=torch.float32, device=device),
            top_p=torch.ones(batch, dtype=torch.float32, device=device),
            top_k=torch.zeros(batch, dtype=torch.int32, device=device),
        )


def fold_in(key: int, data: int) -> int:
    """Mix ``data`` into ``key`` (splitmix64 finaliser): the counterpart of
    ``jax.random.fold_in`` for integer keys. Returns a 63-bit integer."""
    z = (int(key) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def filtered_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Temperature-scaled logits with top-k/top-p filtering applied ([B, V]).

    Filtered-out entries are -inf; greedy rows (temperature <= 0) pass
    through at temperature 1 (callers special-case greedy via argmax).
    """
    b, v = logits.shape
    temp = torch.where(cfg.temperature <= 0.0, torch.ones_like(cfg.temperature),
                       cfg.temperature)
    scaled = logits / temp[:, None]

    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(cfg.top_k > 0, cfg.top_k, torch.full_like(cfg.top_k, v))
    kth = torch.gather(
        sorted_desc, 1, torch.clamp(k[:, None].long() - 1, 0, v - 1))
    neg_inf = torch.tensor(float("-inf"), dtype=scaled.dtype, device=scaled.device)
    masked = torch.where(scaled >= kth, scaled, neg_inf)

    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = (cum - probs_sorted) < cfg.top_p[:, None]
    thresh = torch.amin(
        torch.where(keep_sorted, sorted_desc, -neg_inf), dim=-1, keepdim=True)
    return torch.where(scaled >= thresh, masked, neg_inf)


def target_probs(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Per-row sampling distribution [B, V] (f32) under ``cfg``.

    Greedy rows get a one-hot at the argmax: under stochastic speculative
    verification a one-hot target accepts exactly the argmax path and its
    renormalized residual stays the same one-hot, so the sampling walk
    reproduces the greedy walk with no special casing.
    """
    greedy = (cfg.temperature <= 0.0)[:, None]
    soft = torch.softmax(filtered_logits(logits.float(), cfg), dim=-1)
    onehot = torch.nn.functional.one_hot(
        torch.argmax(logits, dim=-1), logits.shape[-1]).to(torch.float32)
    return torch.where(greedy, onehot, soft)


def sample(
    logits: torch.Tensor,  # [B, V] f32
    key: int,
    cfg: SamplingConfig,
    *,
    greedy_only: bool = False,
    rows=None,
) -> torch.Tensor:
    """One token per row (int32 [B]); greedy rows (temperature <= 0) take
    argmax. ``greedy_only`` skips the sort machinery (every row greedy).
    Row r draws from ``fold_in(key, rows[r])``: ``rows`` names each row's
    global index in its batch (default 0, 1, ...; a data-parallel rank's
    own rows, or a batch's tail, name theirs)."""
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if greedy_only:
        return greedy_tok
    masked = filtered_logits(logits, cfg)
    temps = cfg.temperature.tolist()
    out = greedy_tok.clone()
    for r, t in enumerate(temps):
        if t <= 0.0:
            continue
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(fold_in(key, r if rows is None else rows[r]))
        u = torch.rand(masked.shape[-1], generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        out[r] = torch.argmax(masked[r] + gumbel).to(torch.int32)
    return out


def arg_top_k(logits: torch.Tensor, k: int, *, return_probs: bool = False):
    """Top-k token ids (and optionally softmax probs) per row, the lower id
    first among equal logits."""
    idx = top_k(logits, k)[1]
    if not return_probs:
        return idx
    probs = torch.softmax(logits.float(), dim=-1)
    return idx, torch.gather(probs, -1, idx)
