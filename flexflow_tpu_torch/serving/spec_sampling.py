"""Stochastic speculative verification (port of
``flexflow_tpu/serving/spec_sampling.py``).

The draft proposes each node's children deterministically (beam top-k), so
the proposal for child ``x`` is a point mass at ``x`` and the exact accept
rule becomes: accept ``x`` with probability ``p(x)``; on rejection condition
the target (``p[x] = 0``, renormalized); if no child survives, emit a sample
from the residual. Every emitted token is then distributed exactly per the
target at its node, for any draft tree. Greedy rows need no special case:
``ops.sampling.target_probs`` gives them a one-hot target, under which the
walk is the greedy walk.

Random numbers: row ``r`` draws all its uniforms from one ``torch.Generator``
seeded with ``fold_in(key, row_offset + r)`` (on the logits' device), so a
request's stream depends on (key, global row) only. The bits differ from
``jax.random``'s; parity with JAX is the distribution.
"""

from __future__ import annotations

from typing import Tuple

import torch

from flexflow_tpu_torch.ops.sampling import fold_in


def _row_uniforms(key: int, b: int, n_accept: int, n_emit: int, v: int, device,
                  row_offset: int):
    """Per-row uniforms in [0, 1): accept draws [B, n_accept] and bonus draws
    [B, n_emit, V]."""
    acc, bonus = [], []
    for r in range(b):
        gen = torch.Generator(device=device)
        gen.manual_seed(fold_in(key, row_offset + r))
        acc.append(torch.rand(n_accept, generator=gen, device=device))
        bonus.append(torch.rand((n_emit, v), generator=gen, device=device))
    return torch.stack(acc), torch.stack(bonus)


def tree_sample_walk(
    p_probs: torch.Tensor,  # [B, T, V] f32 target distribution at every tree slot
    tree_tokens: torch.Tensor,  # [B, T] int32 (slot 0 = root)
    tree_parents: torch.Tensor,  # [B, T] int32 (parent slot; -1 for the root)
    key: int,
    *,
    width: int,
    depth: int,
    row_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Walk the verified tree with stochastic acceptance.

    Returns ``(produced [B, depth+1], n_acc [B], from_slots [B, T])`` with the
    greedy walk's contract: ``produced[:, :n_acc]`` are the emitted tokens
    (the last is the bonus or residual sample, whose K/V is not committed),
    and ``from_slots`` feeds the K/V commit (identity past the accepted path).
    """
    b, t, v = p_probs.shape
    if t != 1 + width * depth:
        raise ValueError(f"tree of {t} slots is not 1 + {width} x {depth}")
    dev = p_probs.device
    u_acc, u_bonus = _row_uniforms(key, b, width * depth, depth + 1, v, dev, row_offset)
    gumbel = -torch.log(-torch.log(u_bonus.clamp_min(1e-20)))
    rows = torch.arange(b, device=dev)

    produced = torch.zeros((b, depth + 1), dtype=torch.int32, device=dev)
    from_slots = torch.arange(t, dtype=torch.int32, device=dev)[None].repeat(b, 1)
    cur = torch.zeros(b, dtype=torch.long, device=dev)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    n_acc = torch.zeros(b, dtype=torch.int32, device=dev)
    p = p_probs[:, 0]  # residual target at the current node
    neg_inf = torch.tensor(float("-inf"), device=dev)

    for i in range(depth + 1):
        accepted = torch.zeros(b, dtype=torch.bool, device=dev)
        acc_tok = torch.zeros(b, dtype=torch.long, device=dev)
        acc_slot = torch.zeros(b, dtype=torch.long, device=dev)
        if i < depth:
            for j in range(width):
                c = 1 + i * width + j  # candidate child slot at depth i + 1
                x = tree_tokens[:, c].long()
                is_child = (tree_parents[:, c] == cur) & alive & ~accepted
                px = torch.gather(p, 1, x[:, None])[:, 0]
                acc = is_child & (u_acc[:, i * width + j] < px)
                accepted = accepted | acc
                acc_tok = torch.where(acc, x, acc_tok)
                acc_slot = torch.where(acc, torch.full_like(acc_slot, c), acc_slot)
                # condition the target on the rejection: zero out x
                r = p.clone()
                r[rows, x] = 0.0
                z = r.sum(dim=-1, keepdim=True)
                p_res = torch.where(z > 1e-9, r / z.clamp_min(1e-9), p)
                p = torch.where((is_child & ~acc)[:, None], p_res, p)

        # emit the accepted child, else a sample from the residual target
        logp = torch.where(p > 0, torch.log(p.clamp_min(1e-38)), neg_inf)
        bonus = torch.argmax(logp + gumbel[:, i], dim=-1)
        produced[:, i] = torch.where(accepted, acc_tok, bonus).to(torch.int32)
        n_acc = n_acc + alive.to(torch.int32)
        if i < depth:
            from_slots[:, i + 1] = torch.where(accepted, acc_slot,
                                               torch.full_like(acc_slot, i + 1)).to(torch.int32)
            # moving to the accepted child refreshes the target there
            p = torch.where(accepted[:, None], p_probs[rows, acc_slot], p)
            cur = torch.where(accepted, acc_slot, cur)
            alive = alive & accepted
    return produced, n_acc, from_slots
