"""Pipeline stages: the stage cut of a layer stack and stage balancing
(port of ``flexflow_tpu/parallel/pipeline.py``'s ``stage_params`` and
``balance_stages``).

``stage_range`` / ``stage_params`` give a pipeline stage's contiguous block
of layers, as JAX's ``[P, L/P, ...]`` stage-major reshape places them; the
port's serving stages (``serving/pp_engine.py``) hold only their own
``[L/P, ...]`` slice. ``balance_stages`` is the linear-partition DP that
``parallel.joint.joint_optimize`` with ``pipe > 1`` uses to split the
chosen graph's per-op costs into stages. ``stage_params_uneven`` and
``pipeline_forward`` (the GPipe training loop) are ROADMAP A9c.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.quant.weight_only import QuantizedArray


def stage_range(num_layers: int, num_stages: int, stage: int) -> Tuple[int, int]:
    """Stage ``stage``'s layers ``[lo, hi)`` of ``num_layers`` cut into
    ``num_stages`` equal blocks; raises where they do not divide, as JAX's
    ``stage_params`` does."""
    if num_layers % num_stages:
        raise ValueError(f"num_layers {num_layers} not divisible by pipeline stages "
                         f"{num_stages}")
    if not 0 <= stage < num_stages:
        raise ValueError(f"stage {stage} outside {num_stages} pipeline stages")
    w = num_layers // num_stages
    return stage * w, (stage + 1) * w


def stage_slice(leaf, lo: int, hi: int):
    """Layers ``[lo, hi)`` of a ``[L, ...]`` leaf (a tensor or a stacked
    carrier), copied: the whole stack's storage is not kept alive."""
    if isinstance(leaf, QuantizedArray):
        def cut(t):
            return None if t is None else t[lo:hi].clone()

        return dataclasses.replace(leaf, q=cut(leaf.q), scale=cut(leaf.scale),
                                   offset=cut(leaf.offset),
                                   shape=(hi - lo, *leaf.shape[1:]))
    return leaf[lo:hi].clone()


def _stage_major(leaf: torch.Tensor, num_stages: int) -> torch.Tensor:
    """``[L, ...]`` -> ``[P, L/P, ...]``."""
    l = leaf.shape[0]
    stage_range(l, num_stages, 0)
    return leaf.reshape(num_stages, l // num_stages, *leaf.shape[1:])


def stage_params(params, num_stages: int, stage: Optional[int] = None):
    """A tree of stacked ``[L, ...]`` layer leaves cut into pipeline stages.

    With ``stage``: that stage's ``[L/P, ...]`` slice of every leaf, tensor
    or carrier (what a stage rank holds). Without: JAX's stage-major
    ``[P, L/P, ...]`` form of every (float) leaf, stage ``s`` at index
    ``s``. ``L % P != 0`` raises."""
    if isinstance(params, dict):
        return {k: stage_params(v, num_stages, stage) for k, v in params.items()}
    if params is None:
        return None
    if stage is None:
        return _stage_major(params, num_stages)
    return stage_slice(params, *stage_range(params.shape[0], num_stages, stage))


def balance_stages(costs: Sequence[float], num_stages: int) -> List[int]:
    """Contiguous layer -> stage assignment minimizing the max stage cost.

    In a synchronized pipeline every tick waits for the slowest stage, so
    the best boundaries minimize the largest stage sum: the classic
    linear-partition DP. Uniform costs reduce to the even split.

    Returns a list of per-stage layer counts summing to ``len(costs)``.
    """
    l, p = len(costs), num_stages
    assert 1 <= p <= l, (l, p)
    pre = np.concatenate([[0.0], np.cumsum(np.asarray(costs, float))])
    # dp[k][i] = min over splits of the first i layers into k stages of the
    # max stage sum; cut[k][i] = the boundary achieving it
    dp = np.full((p + 1, l + 1), np.inf)
    cut = np.zeros((p + 1, l + 1), np.int64)
    dp[0][0] = 0.0
    for k in range(1, p + 1):
        for i in range(k, l + 1):
            for j in range(k - 1, i):
                cand = max(dp[k - 1][j], pre[i] - pre[j])
                if cand < dp[k][i]:
                    dp[k][i], cut[k][i] = cand, j
    sizes = []
    i = l
    for k in range(p, 0, -1):
        j = int(cut[k][i])
        sizes.append(i - j)
        i = j
    sizes.reverse()
    assert all(s >= 1 for s in sizes) and sum(sizes) == l
    return sizes
