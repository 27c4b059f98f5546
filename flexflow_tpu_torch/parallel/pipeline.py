"""Pipeline stages: the stage cut of a layer stack, stage balancing, and
the GPipe loop over the ``pipe`` ranks of a ``parallel/mesh.Mesh`` (port
of ``flexflow_tpu/parallel/pipeline.py``).

``stage_range`` / ``stage_params`` give a pipeline stage's contiguous block
of layers, even (JAX's ``[P, L/P, ...]`` stage-major reshape) or uneven
(``sizes``: the stage's real layers, no padding); ``stage_params_uneven``
also gives JAX's padded ``[P, kmax, ...]`` form. ``balance_stages`` is the
linear-partition DP that ``parallel.joint.joint_optimize`` with ``pipe >
1`` uses to split the chosen graph's per-op costs into stages.

JAX runs the pipe as one ``shard_map`` over ``("data", "pipe", "model")``
that scans M + P - 1 ticks, rotating activations with ``ppermute``, and
``jax.grad`` through that scan gives the reverse pipeline. The port runs
one process per rank (SPMD), as the serving stages do
(``serving/pp_engine.py``): each rank holds only its stage's layers and
its tensor-parallel cut (``parallel/sharding.shard_params``), stage 0
embeds, every later stage receives the hidden state (``Mesh.recv_prev``),
runs its layers through ``decoder.forward(hidden=, head=False, shard=)``
and passes it on (``Mesh.send_next``), and the last stage applies the
final norm and the head. ``remat=True`` checkpoints each layer
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint``): the same bits,
activation memory bounded by one layer's.

:func:`pipeline_forward` is JAX's: the f32 logits of the whole batch on
every rank (the last stage's, broadcast over ``pipe``; JAX sums over
``pipe`` with ``psum``), each microbatch's rows split over ``data`` where
they divide. :func:`gpipe_step` is the training step: autograd does not
promise an order across independent microbatch graphs, and a blocking
hop must meet its send one for one, so the backward runs by hand,
microbatch M-1 first: the last stage back-propagates that microbatch's
share of the loss (its parts ``(sum, count)`` over the global label
count: JAX's mean), every other stage receives the gradient of its
output from the stage after (``Mesh.recv_next``) and back-propagates it,
and every stage but the first sends its input's gradient back
(``Mesh.send_prev``). The gradient sums and the update are the Trainer's
(``training/trainer.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.quant.weight_only import QuantizedArray


def stage_range(num_layers: int, num_stages: int, stage: int,
                sizes: Optional[Sequence[int]] = None) -> Tuple[int, int]:
    """Stage ``stage``'s layers ``[lo, hi)`` of ``num_layers`` cut into
    ``num_stages`` equal blocks (raises where they do not divide, as JAX's
    ``stage_params`` does), or into the blocks of ``sizes`` (each stage's
    layer count, at least 1, summing to ``num_layers``)."""
    if not 0 <= stage < num_stages:
        raise ValueError(f"stage {stage} outside {num_stages} pipeline stages")
    if sizes is None:
        if num_layers % num_stages:
            raise ValueError(f"num_layers {num_layers} not divisible by pipeline stages "
                             f"{num_stages}")
        w = num_layers // num_stages
        return stage * w, (stage + 1) * w
    sizes = [int(n) for n in sizes]
    if len(sizes) != num_stages or min(sizes) < 1 or sum(sizes) != num_layers:
        raise ValueError(f"stage sizes {sizes} do not cut {num_layers} layers into "
                         f"{num_stages} stages of at least one layer")
    lo = sum(sizes[:stage])
    return lo, lo + sizes[stage]


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


def _stage_major(leaf: torch.Tensor, num_stages: int, sizes) -> torch.Tensor:
    """``[L, ...]`` -> ``[P, kmax, ...]``, each stage's layers at its index,
    zero layers after them where ``sizes`` are uneven (JAX's padding)."""
    l = leaf.shape[0]
    ranges = [stage_range(l, num_stages, s, sizes) for s in range(num_stages)]
    kmax = max(hi - lo for lo, hi in ranges)
    out = leaf.new_zeros((num_stages, kmax, *leaf.shape[1:]))
    for s, (lo, hi) in enumerate(ranges):
        out[s, :hi - lo] = leaf[lo:hi]
    return out


def stage_params(params, num_stages: int, stage: Optional[int] = None,
                 sizes: Optional[Sequence[int]] = None):
    """A tree of stacked ``[L, ...]`` layer leaves cut into pipeline stages
    (equal ones, or the uneven ``sizes``).

    With ``stage``: that stage's ``[n_s, ...]`` slice of every leaf, tensor
    or carrier (what a stage rank holds). Without: JAX's stage-major
    ``[P, kmax, ...]`` form of every (float) leaf, stage ``s`` at index
    ``s``, padded with zero layers where the stages are uneven. Equal
    stages with ``L % P != 0`` raise."""
    if isinstance(params, dict):
        return {k: stage_params(v, num_stages, stage, sizes) for k, v in params.items()}
    if params is None:
        return None
    if stage is None:
        return _stage_major(params, num_stages, sizes)
    return stage_slice(params, *stage_range(params.shape[0], num_stages, stage, sizes))


def stage_params_uneven(params, sizes: Sequence[int], stage: Optional[int] = None):
    """Stage-cut stacked ``[L, ...]`` layer leaves with uneven per-stage
    layer counts ``sizes``: without ``stage`` JAX's form, each stage's
    slice padded with zero layers to ``max(sizes)`` (``[P, kmax, ...]``);
    with ``stage`` that stage's real layers."""
    return stage_params(params, len(sizes), stage, sizes)


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


# ---------------------------------------------------------------------------
# the GPipe loop over a mesh's pipe ranks
# ---------------------------------------------------------------------------


def _check_stage_sizes(spec, stage_sizes: Optional[Sequence[int]], num_stages: int) -> None:
    """JAX's conditions on uneven stages: a pre-norm or parallel-attention
    spec (its padded layers must pass the residual through), one size a
    stage."""
    if stage_sizes is None:
        return
    if not (spec.pre_norm or spec.parallel_attn):
        raise ValueError("uneven stages need pre-norm residual passthrough padding")
    if len(stage_sizes) != num_stages:
        raise ValueError(f"stage_sizes {list(stage_sizes)} for {num_stages} pipeline stages")


def _layers(spec, params, shard, positions, lengths, h, remat: bool):
    """This stage's layers on one microbatch's hidden state, each through
    ``decoder.forward`` on its own (under a gradient and ``remat``, inside
    a ``torch.utils.checkpoint``)."""
    from torch.utils.checkpoint import checkpoint

    from flexflow_tpu_torch.models import decoder

    layers = params["layers"]
    for i in range(decoder._stack_depth(layers)):
        one = {"layers": {k: v[i:i + 1] for k, v in layers.items()}}

        def layer(x, one=one):
            return decoder.forward(spec, one, None, positions, lengths=lengths, hidden=x,
                                   head=False, shard=shard)[0]

        h = (checkpoint(layer, h, use_reentrant=False)
             if remat and torch.is_grad_enabled() and h.requires_grad else layer(h))
    return h


def _forward(spec, params, shard, mesh, toks, pos, lens, remat: bool):
    """Every microbatch through this rank's stage, in order: [(the hidden
    state received, a leaf that requires grad under a gradient (None on
    stage 0), the stage's output)]. Ends the forward hops it sent."""
    from flexflow_tpu_torch.models import decoder

    act = params["layers"]["ln1_scale"].dtype  # the hidden state's, on every hop
    outs = []
    for tk, ps, ln in zip(toks, pos, lens):
        if mesh.first_stage:
            x, h = None, decoder._embed(spec, params, tk, ps, shard)
        else:
            x = mesh.recv_prev(torch.empty((*tk.shape, spec.hidden_size), dtype=act,
                                           device=tk.device))
            h = x.requires_grad_(torch.is_grad_enabled())
        y = _layers(spec, params, shard, ps, ln, h, remat)
        if not mesh.last_stage:
            mesh.send_next(y.detach())
        outs.append((x, y))
    mesh.wait_sends()
    return outs


def _decoder_shard(shard):
    """The shard the decoder runs under: none at one model rank (no
    collective)."""
    return shard if shard is not None and shard.mesh.model > 1 else None


def pipeline_forward(spec, params, tokens: torch.Tensor, positions: torch.Tensor, *, mesh,
                     num_microbatches: Optional[int] = None,
                     lengths: Optional[torch.Tensor] = None, remat: bool = True,
                     stage_sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The forward through the pipeline stages of ``mesh``; returns the f32
    logits ``[B, T, V]`` of the whole batch on every rank (JAX's contract).

    ``params``: the whole (one-device) float tree or this rank's cut of it
    (``sharding.shard_params`` with the same ``stage_sizes``). The batch
    splits into ``num_microbatches`` (default P) microbatches of ``B / M``
    rows, each split over ``data`` where it divides (else every data rank
    runs it whole), as JAX's ``shard_map`` places them. ``stage_sizes``:
    uneven per-stage layer counts (``balance_stages``); each stage runs
    only its real layers. No gradient flows through the hops: training is
    :func:`gpipe_step`."""
    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.parallel.mesh import DATA_AXIS
    from flexflow_tpu_torch.parallel.sharding import shard_params, tree_shard

    _check_stage_sizes(spec, stage_sizes, mesh.pipe)
    b, t = tokens.shape
    m = num_microbatches or max(mesh.pipe, 1)
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    bm, d, dev = b // m, mesh.data, mesh.device
    shard = _decoder_shard(tree_shard(spec, params, mesh, stage_sizes=stage_sizes))
    params = shard_params(spec, params, mesh, stage_sizes=stage_sizes)
    params = {k: (v.to(dev) if k != "layers" else {n: a.to(dev) for n, a in v.items()})
              for k, v in params.items()}
    split = bm % d == 0
    w = bm // d if split else bm
    off = mesh.data_rank * w if split else 0
    rows = [slice(i * bm + off, i * bm + off + w) for i in range(m)]
    tokens, positions = tokens.to(dev), positions.to(dev)
    lens = [None if lengths is None else lengths.to(dev)[r] for r in rows]
    with torch.no_grad():
        outs = _forward(spec, params, shard, mesh, [tokens[r] for r in rows],
                        [positions[r] for r in rows], lens, remat)
        if mesh.last_stage:
            logits = torch.cat([decoder._unembed(spec, params, y, shard) for _, y in outs])
        else:
            logits = torch.empty((m * w, t, spec.vocab_size), dtype=torch.float32, device=dev)
    logits = mesh.broadcast_from_stage(logits, mesh.pipe - 1)
    if split and d > 1:  # [D * M * w] data rank-major -> the batch's row order
        logits = mesh.all_gather(logits, 0, DATA_AXIS)
        logits = logits.reshape(d, m, w, t, -1).transpose(0, 1).reshape(b, t, -1)
    return logits


def gpipe_step(spec, params, shard, tokens: torch.Tensor, labels: torch.Tensor, loss_parts,
               *, num_microbatches: Optional[int] = None, remat: bool = True,
               backward: bool = True) -> Optional[torch.Tensor]:
    """One GPipe step of this rank (``shard``: its ``Shard`` with stages;
    ``params``: its cut, leaves that require grad) on its data rank's rows
    ``tokens`` / ``labels`` [b, T], cut into ``num_microbatches`` (default
    P) microbatches; ``b % M`` raises JAX's text.

    ``loss_parts(logits, labels)`` gives a microbatch's scalars on the last
    stage: its loss sum (differentiable), its label count, then any counts
    to ride along (``losses.LOSS_PARTS`` gives the first two). Returns
    their sums over the microbatches and the data ranks (float64) on the
    last stage, None on the others. With ``backward`` each leaf's ``.grad``
    gains this rank's part of the gradient of the mean loss (the sum over
    the count): the explicit backward of the module docstring. Summing the
    parts (over ``model``, ``data`` and a tied embedding's two stages) is
    the caller's."""
    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.parallel.mesh import DATA_AXIS

    mesh = shard.mesh
    b, t = tokens.shape
    m = num_microbatches or mesh.pipe
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    dshard = _decoder_shard(shard)
    positions = torch.arange(t, dtype=torch.int32, device=tokens.device)[None].expand(b, t)
    stats, totals = None, []
    with torch.set_grad_enabled(backward):
        outs = _forward(spec, params, dshard, mesh, tokens.chunk(m), positions.chunk(m),
                        [None] * m, remat)
        if mesh.last_stage:
            for (_, y), lab in zip(outs, labels.chunk(m)):
                parts = loss_parts(decoder._unembed(spec, params, y, dshard), lab)
                totals.append(parts[0])
                mb = torch.stack([p.detach().double() for p in parts])
                stats = mb if stats is None else stats + mb
            if mesh.data > 1:
                mesh.all_reduce(stats, DATA_AXIS)
    if backward:
        denom = None if stats is None else stats[1].clamp_min(1).float()
        for i in reversed(range(m)):
            x, y = outs[i]
            if mesh.last_stage:
                (totals[i] / denom).backward()
            else:
                torch.autograd.backward(y, mesh.recv_next(y))
            if not mesh.first_stage:
                mesh.send_prev(x.grad)
            outs[i] = None
        mesh.wait_sends()
    return stats
