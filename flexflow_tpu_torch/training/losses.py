"""Loss functions (port of ``flexflow_tpu/training/losses.py``).

Scalar losses in float32; ``torch.autograd`` seeds the logit gradients where
JAX takes ``jax.grad`` of the same functions. Mean over the labels that are
not ``IGNORE_INDEX``.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def sparse_categorical_crossentropy(logits: torch.Tensor, labels: torch.Tensor, *,
                                    ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Mean token-level cross entropy of ``logits`` [..., V] (pre-softmax)
    against integer ``labels`` [...], over the labels not ``ignore_index``."""
    logits = logits.float()
    labels = labels.long()
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - ll) * mask
    return nll.sum() / mask.sum().clamp_min(1)


def categorical_crossentropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Dense-target cross entropy (``targets`` are probability rows)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(targets * logp, dim=-1))


def mean_squared_error(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - target.float()))


def identity_loss(pred: torch.Tensor) -> torch.Tensor:
    """Mean of the output (the reference's identity loss)."""
    return torch.mean(pred.float())


LOSSES = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "mean_squared_error": mean_squared_error,
    "identity": identity_loss,
}
