"""Pipeline stage balancing (port of ``balance_stages`` in
``flexflow_tpu/parallel/pipeline.py``).

Only the linear-partition DP is here: ``parallel.joint.joint_optimize``
with ``pipe > 1`` uses it to split the chosen graph's per-op costs into
stages, which needs no mesh. The rest of the JAX module (``stage_params``,
``pipeline_forward``: stage-sliced layers and the microbatched loop over a
pipe axis) is ROADMAP A9.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


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
