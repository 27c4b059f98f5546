"""Mixture-of-experts FFN (port of ``flexflow_tpu/ops/moe.py`` and of the
dense branch of ``_moe_mlp`` in ``flexflow_tpu/models/decoder.py``).

Routing is softmax in f32, top-k, renormalize (HF Mixtral's gate). Two forms
compute the SwiGLU experts, with the same results:

- ``moe_ffn_dense``: every expert on every token, combined by the routing
  weights (zero for unrouted experts). Static shapes and no host read, so a
  decode step that runs it can be captured in a CUDA graph. E / top_k times
  the routed FLOPs.
- ``moe_ffn_ragged``: a stable sort by expert, one group of rows per expert,
  a weighted scatter-add back (JAX's ``lax.ragged_dot`` dispatch). The
  group sizes are read on the host, one read per call.

Both loop over the experts and call the quant-matmul with an expert index on
quantized stacks, so no ``[N, E, F]`` tensor is ever built. Each combines in
float32 and rounds to the activation dtype once. Every routed row gets the
same bits in both forms: the quant-matmul's rows do not depend on how many
rows a call carries, and a token's top-2 contributions are added in expert
order onto zero either way.

Under tensor parallelism (``partial=True``) each expert holds a rank's
columns of ``wg`` / ``wu`` and rows of ``wd``: its ``wd`` product stays
float32, and the combine comes back float32 and unrounded, for the caller
to sum over the model axis and round once. Under expert parallelism
(``experts``: the global ids of the rank's stack, whole experts) both forms
compute only those experts, each as one device computes it, routed by its
global id's combine weight; the combine comes back float32 and unrounded,
for the caller to sum over the model axis. With top-2 routing a row's sum
then has the one-device terms, two of them non-zero, so the bits agree.

The router logits (``router_logits``) are one f32 GEMM in blocks of
``ROUTER_ROWS`` rows, so a row's logits do not depend on how many rows the
call carries either: a token verified in a speculative tree routes as its
incremental decode step did.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from flexflow_tpu_torch.ops import activations as act_lib
from flexflow_tpu_torch.ops import topk as topk_lib
from flexflow_tpu_torch.ops.kernels.quant_matmul import LayerQuant, quant_matmul
from flexflow_tpu_torch.quant.weight_only import QuantizedArray

Experts = Union[torch.Tensor, QuantizedArray, LayerQuant]


ROUTER_ROWS = 128  # rows of one router GEMM


def router_logits(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """f32 router logits [N, E] of x [N, D] and the router [D, E]. A GEMM's
    library picks its algorithm by shape, which changes a row's summation
    order with the row count; so every GEMM here has ``ROUTER_ROWS`` rows
    (the last block zero-padded), whatever N is."""
    x, w = x.float(), router.float()
    n = x.shape[0]
    pad = -n % ROUTER_ROWS
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    return torch.cat([block @ w for block in x.split(ROUTER_ROWS)])[:n]


def route_topk(router_logits: torch.Tensor, top_k: int):
    """Softmax -> top-k -> renormalize. Returns (weights [N, K] f32,
    expert ids [N, K], highest weight first, the lower id first on a tie)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    topw, topi = topk_lib.top_k(probs, top_k)
    return topw / topw.sum(dim=-1, keepdim=True), topi


def expert_matmul(x: torch.Tensor, w: Experts, e: int, out_dtype=None) -> torch.Tensor:
    """x [N, D] @ expert ``e`` of ``w``: a plain [E, D, F] tensor, an
    [E, D, F] QuantizedArray, or a layer of a [L, E, D, F] quantized stack;
    in x's dtype or ``out_dtype`` (float32)."""
    if isinstance(w, LayerQuant):
        return quant_matmul(x, w.qa, layer=w.layer, expert=e, out_dtype=out_dtype)
    if isinstance(w, QuantizedArray):
        return quant_matmul(x, w, layer=e, out_dtype=out_dtype)
    if out_dtype is not None:
        return torch.matmul(x.to(out_dtype), w[e].to(out_dtype))
    return torch.matmul(x, w[e])


def _swiglu_expert(x, wg, wu, wd, e: int, partial: bool = False) -> torch.Tensor:
    inner = act_lib.sigmoid_silu_multi(expert_matmul(x, wg, e), expert_matmul(x, wu, e))
    return expert_matmul(inner, wd, e, torch.float32 if partial else None)


def _stack_ids(n_exp: int, experts: Optional[Sequence[int]]):
    """(index in the stack, global expert id) of each expert the stacks hold."""
    return list(enumerate(range(n_exp) if experts is None else experts))


def moe_ffn_dense(x: torch.Tensor, router_logits: torch.Tensor, wg: Experts, wu: Experts,
                  wd: Experts, top_k: int, partial: bool = False,
                  experts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """x [N, D], router logits [N, E] -> [N, D]: every expert of the stacks
    (``experts``: their global ids; default all E) on every row, weighted
    by the routing (zero where a row is not routed); float32 and unrounded
    with ``partial`` (a tensor- or expert-parallel rank's share)."""
    topw, topi = route_topk(router_logits, top_k)
    combine = torch.zeros(router_logits.shape, dtype=torch.float32,
                          device=x.device).scatter_(-1, topi, topw)  # [N, E]
    cut = partial and experts is None  # each expert a TP cut: its wd product in f32
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j, e in _stack_ids(router_logits.shape[-1], experts):
        out += _swiglu_expert(x, wg, wu, wd, j, cut).float() * combine[:, e:e + 1]
    return out if partial else out.to(x.dtype)


def moe_ffn_ragged(x: torch.Tensor, router_logits: torch.Tensor, wg: Experts, wu: Experts,
                   wd: Experts, top_k: int, partial: bool = False,
                   experts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """x [N, D], router logits [N, E] -> [N, D]: each expert of the stacks
    (``experts``: their global ids; default all E) on the rows routed to
    it (sort-based dispatch), weighted scatter-add back (float32 and
    unrounded with ``partial``)."""
    n_exp = router_logits.shape[-1]
    topw, topi = route_topk(router_logits, top_k)
    flat_expert = topi.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    token_idx = order // top_k
    x_sorted = x[token_idx]
    w_sorted = topw.reshape(-1)[order]
    sizes = torch.bincount(flat_expert, minlength=n_exp).tolist()  # the host read
    starts = [sum(sizes[:e]) for e in range(n_exp)]
    cut = partial and experts is None
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j, e in _stack_ids(n_exp, experts):
        if sizes[e]:
            rows = slice(starts[e], starts[e] + sizes[e])
            y = _swiglu_expert(x_sorted[rows], wg, wu, wd, j, cut)
            out.index_add_(0, token_idx[rows], y.float() * w_sorted[rows, None])
    return out if partial else out.to(x.dtype)
