"""Training metrics (port of ``flexflow_tpu/training/metrics.py``).

``classification_metrics`` and ``regression_metrics`` return device
tensors; ``PerfMetrics`` accumulates host numbers from them. A data-parallel
Trainer sums ``count`` and ``correct`` over its data ranks
(``global_counts``) before they reach the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from flexflow_tpu_torch.training.losses import IGNORE_INDEX


@dataclasses.dataclass
class PerfMetrics:
    """Host-side accumulated metrics (the reference's PerfMetrics)."""

    train_all: int = 0
    train_correct: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    mae_loss: float = 0.0

    def update(self, other: Dict[str, float]) -> None:
        self.train_all += int(other.get("count", 0))
        self.train_correct += int(other.get("correct", 0))
        for k in ("cce_loss", "sparse_cce_loss", "mse_loss", "mae_loss"):
            if k in other:
                setattr(self, k, getattr(self, k) + float(other[k]))

    @property
    def accuracy(self) -> float:
        return self.train_correct / max(self.train_all, 1)


def classification_metrics(logits: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{count, correct} over the labels not ``IGNORE_INDEX`` (device tensors)."""
    mask = labels != IGNORE_INDEX
    pred = torch.argmax(logits, dim=-1)
    return {"count": mask.sum(), "correct": ((pred == labels) & mask).sum()}


def global_counts(m: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """``count`` and ``correct`` summed over the data ranks of ``mesh`` (one
    collective; None or one data rank: ``m`` as it is)."""
    if mesh is None or mesh.data == 1:
        return m
    from flexflow_tpu_torch.parallel.mesh import DATA_AXIS

    both = mesh.all_reduce(torch.stack([m["count"], m["correct"]]).long(), DATA_AXIS)
    return {**m, "count": both[0], "correct": both[1]}


def regression_metrics(pred: torch.Tensor, target: torch.Tensor) -> Dict[str, torch.Tensor]:
    diff = pred.float() - target.float()
    return {"mse_loss": torch.mean(torch.square(diff)), "mae_loss": torch.mean(torch.abs(diff))}
