"""Token-tree merging for several drafts (port of
``flexflow_tpu/serving/tree_merge.py``; the reference's ``merge_dfs_trees``).

Merged verification checks every draft's speculation tree in one verifier
pass: each draft's beam tree is walked in slot order and merged into one
token tree, shared prefixes deduplicated, capped at
``MAX_SPEC_TREE_TOKEN_NUM`` nodes. Numpy on the host, over the
``(tokens, parents)`` layout of ``SpecEngine.draft_tree``.

Merged trees are irregular, so they go through the engine's stepwise
``verify`` (explicit parents and an ancestor mask) and ``commit_llm_only``,
not the fixed width x depth layout of the fused iteration.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def merge_dfs_trees(
    trees: Sequence[Tuple[np.ndarray, np.ndarray]],
    cap: int,
    pad_to: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge one request's draft trees (one root) into one deduplicated
    token tree.

    trees: per draft, ``(tokens [T_i], parents [T_i])``; slot 0 is the
        shared root (the last committed token) with parent -1, and parents
        precede their children.
    cap: the most merged nodes, root included.
    pad_to: the fixed output size. Padding slots get token 0 and parent -2,
        which no walk position matches: they are never accepted and attend
        only themselves in verification.

    Returns ``(tokens [pad_to], parents [pad_to], depths [pad_to])``.
    """
    if cap > pad_to:
        raise ValueError(f"cap {cap} exceeds pad_to {pad_to}")
    out_tokens = [int(trees[0][0][0])]
    out_parents = [-1]
    out_depths = [0]
    index = {}  # (merged parent, token) -> merged slot: the shared-prefix dedup
    for tokens, parents in trees:
        if int(tokens[0]) != out_tokens[0]:
            raise ValueError("the trees must share their root")
        slot_map = {0: 0}  # this tree's slot -> merged slot
        for s in range(1, len(tokens)):
            p = int(parents[s])
            if p not in slot_map:  # its parent's subtree was dropped at the cap
                continue
            mp = slot_map[p]
            key = (mp, int(tokens[s]))
            if key in index:
                slot_map[s] = index[key]
                continue
            if len(out_tokens) >= cap:
                continue
            index[key] = slot_map[s] = len(out_tokens)
            out_tokens.append(int(tokens[s]))
            out_parents.append(mp)
            out_depths.append(out_depths[mp] + 1)

    n = len(out_tokens)
    t = np.zeros(pad_to, np.int32)
    p = np.full(pad_to, -2, np.int32)
    d = np.zeros(pad_to, np.int32)
    t[:n], p[:n], d[:n] = out_tokens, out_parents, out_depths
    return t, p, d


def merge_batch(
    per_ssm: Sequence[Tuple[np.ndarray, np.ndarray]],
    cap: int,
    pad_to: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``merge_dfs_trees`` row by row: ``per_ssm`` holds each draft's
    ``(tokens [B, T_i], parents [B, T_i])``; returns ``(tokens, parents,
    depths)``, each [B, pad_to]."""
    rows = [merge_dfs_trees([(tk[r], pr[r]) for tk, pr in per_ssm], cap, pad_to)
            for r in range(per_ssm[0][0].shape[0])]
    return tuple(np.stack(x) for x in zip(*rows))
