"""Loss functions (port of ``flexflow_tpu/training/losses.py``).

Scalar losses in float32; ``torch.autograd`` seeds the logit gradients where
JAX takes ``jax.grad`` of the same functions. Mean over the labels that are
not ``IGNORE_INDEX``.

``LOSS_PARTS`` gives each loss as ``(sum, count)``, the form a data-parallel
Trainer needs: its global mean is the sum over the data ranks over the
count over them (a rank whose labels are all ignored gives 0 and 0), as
JAX's mean over the whole sharded batch.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def sparse_categorical_crossentropy_parts(logits: torch.Tensor, labels: torch.Tensor, *,
                                          ignore_index: int = IGNORE_INDEX):
    """(sum of the token cross entropies, count) over the labels not
    ``ignore_index``."""
    logits = logits.float()
    labels = labels.long()
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - ll) * mask
    return nll.sum(), mask.sum()


def sparse_categorical_crossentropy(logits: torch.Tensor, labels: torch.Tensor, *,
                                    ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Mean token-level cross entropy of ``logits`` [..., V] (pre-softmax)
    against integer ``labels`` [...], over the labels not ``ignore_index``."""
    total, count = sparse_categorical_crossentropy_parts(logits, labels,
                                                         ignore_index=ignore_index)
    return total / count.clamp_min(1)


def categorical_crossentropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Dense-target cross entropy (``targets`` are probability rows)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(targets * logp, dim=-1))


def mean_squared_error(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - target.float()))


def identity_loss(pred: torch.Tensor) -> torch.Tensor:
    """Mean of the output (the reference's identity loss)."""
    return torch.mean(pred.float())


def _numel(x: torch.Tensor, dims: int = 0) -> torch.Tensor:
    """The element count of ``x`` without its last ``dims`` axes, as a tensor."""
    return torch.tensor(x.shape[:x.dim() - dims].numel(), device=x.device)


LOSS_PARTS = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy_parts,
    "categorical_crossentropy": lambda logits, targets: (
        -torch.sum(targets * torch.log_softmax(logits.float(), dim=-1)), _numel(logits, 1)),
    "mean_squared_error": lambda pred, target: (
        torch.sum(torch.square(pred.float() - target.float())), _numel(pred)),
    "identity": lambda pred: (torch.sum(pred.float()), _numel(pred)),
}

LOSSES = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "mean_squared_error": mean_squared_error,
    "identity": identity_loss,
}
