"""Optimizers: SGD (momentum, nesterov, weight decay) and Adam (port of
``flexflow_tpu/training/optimizers.py``, the same update formulas).

Parameter trees are the port's dicts (and lists or tuples) of tensors; the
states are the JAX package's NamedTuples over the same tree, so a train
state saved by either package's ``utils/checkpoint`` loads in the other.

``update(grads, state, params)`` runs under ``torch.no_grad()`` and writes
the new values into ``params`` and the state's tensors in place, then
returns them (JAX returns new trees). In place is what lets a parameter be
a view of a buffer that something else reads by address: a LoRA slot of
the serving engine's routed adapters, which its captured CUDA graphs read
(``peft/finetune.py``). A gradient of None counts as zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, NamedTuple, Tuple

import torch


def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """``fn`` on every tensor leaf of a dict / list / tuple tree (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def zip_leaves(first, *others) -> Iterator[Tuple]:
    """The leaves of ``first`` with the leaves at the same paths of
    ``others`` (a missing subtree gives None); None leaves of ``first`` are
    skipped."""
    if isinstance(first, dict):
        for k, v in first.items():
            yield from zip_leaves(v, *(None if o is None else o.get(k) for o in others))
    elif isinstance(first, (list, tuple)):
        for i, v in enumerate(first):
            yield from zip_leaves(v, *(None if o is None else o[i] for o in others))
    elif first is not None:
        yield (first, *others)


def _grad(g, p):
    return torch.zeros_like(p) if g is None else g


class SGDState(NamedTuple):
    velocity: Any


@dataclasses.dataclass(frozen=True)
class SGDOptimizer:
    """SGD with momentum and weight decay (the reference's optimizer.h:28-66)."""

    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    def init(self, params) -> SGDState:
        return SGDState(velocity=tree_map(torch.zeros_like, params) if self.momentum else None)

    @torch.no_grad()
    def update(self, grads, state: SGDState, params) -> Tuple[Any, SGDState]:
        for p, g, v in zip_leaves(params, grads, state.velocity):
            g = _grad(g, p) + self.weight_decay * p
            if not self.momentum:
                p.sub_(self.lr * g)
                continue
            v.mul_(self.momentum).add_(g)
            step = g + self.momentum * v if self.nesterov else v
            p.sub_(self.lr * step)
        return params, state


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamOptimizer:
    """Adam (the reference's optimizer.h:68-110)."""

    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params) -> AdamState:
        device = next((p.device for p, in zip_leaves(params)), torch.device("cpu"))
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                         m=tree_map(torch.zeros_like, params),
                         v=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params) -> Tuple[Any, AdamState]:
        state.step.add_(1)
        t = state.step.float()  # the bias corrections in f32, on the device
        b1t = 1.0 - self.beta1 ** t
        b2t = 1.0 - self.beta2 ** t
        for p, g, m, v in zip_leaves(params, grads, state.m, state.v):
            g = _grad(g, p) + self.weight_decay * p
            m.mul_(self.beta1).add_((1 - self.beta1) * g)
            v.mul_(self.beta2).add_((1 - self.beta2) * torch.square(g))
            mhat = m / b1t
            vhat = v / b2t
            p.sub_(self.lr * mhat / (torch.sqrt(vhat) + self.eps))
        return params, state
