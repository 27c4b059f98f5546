"""Top-k in ``jax.lax.top_k``'s order.

``torch.topk`` returns equal values in an order of its own, which differs
between the CPU and CUDA and between row widths; ``jax.lax.top_k`` puts the
lower index first among equal values. Every top-k of the port that the JAX
package computes with ``jax.lax.top_k`` (the FFModel ``top_k``,
``arg_top_k`` and ``moe`` ops, MoE routing, the draft-tree expansion and
``sampling.arg_top_k``) goes through ``top_k`` here, so ties pick the same
indices in both packages.

A stable descending sort keeps equal values in index order; its first k
entries are JAX's. It takes no host read and can be captured in a CUDA
graph.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last dimension and their int64
    indices, in descending order, the lower index first among equal values
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
