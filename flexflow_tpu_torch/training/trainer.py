"""Trainer: train and eval steps and the fit loop on one device (port of
``flexflow_tpu/training/trainer.py``).

JAX jits one program per step (forward, ``value_and_grad``, the optimizer
update, metrics). Here a step runs eagerly: ``decoder.forward`` (its plain
attention; ``flash=True`` is inference-only in both packages), the loss,
``backward()``, and the optimizer's in-place update. The parameters are the
JAX package's unfused tree, copied once into leaf tensors that require
grad on the Trainer's device.

Quantized parameters are refused (``TypeError``): JAX cannot take a
gradient of integer leaves either. ``mesh="auto"`` runs the layout search
(``parallel/auto.optimize_train_layout``: on one device it measures the
only layout, dp = pp = tp = 1, and trains under it; its report is
``auto_report``). A mesh and pipeline stages are not in the port yet and
raise ``NotImplementedError`` naming their ROADMAP items (A8b, A9; the
search over more than one device, A11c).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.device import resolve_device
from flexflow_tpu_torch.models import decoder
from flexflow_tpu_torch.quant.weight_only import QuantizedArray
from flexflow_tpu_torch.specs import ModelSpec
from flexflow_tpu_torch.training import losses as loss_lib
from flexflow_tpu_torch.training import metrics as metrics_lib
from flexflow_tpu_torch.training.optimizers import tree_map, zip_leaves


def _trainable(device):
    def leaf(t):
        if isinstance(t, QuantizedArray) or not torch.is_floating_point(t):
            raise TypeError(
                f"the Trainer takes float parameters; got a {type(t).__name__} leaf "
                "(a quantized or integer leaf has no gradient, in JAX as here)")
        return t.detach().to(device, copy=True).requires_grad_()

    return leaf


class Trainer:
    """Causal-LM trainer on one device."""

    def __init__(self, spec: ModelSpec, params: Any, optimizer, *, mesh=None,
                 pipeline_stages: int = 1, loss: str = "sparse_categorical_crossentropy",
                 auto_batch_size: int = 8, auto_seq_len: int = 128, device=None):
        """``mesh="auto"`` measures the legal layouts' train steps at
        (``auto_batch_size``, ``auto_seq_len``) and trains under the
        fastest; on one device that is no mesh."""
        self.auto_report = None
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh must be a mesh or 'auto', got {mesh!r}")
            from flexflow_tpu_torch.parallel import auto as auto_lib

            layout, self.auto_report = auto_lib.optimize_train_layout(
                spec, params, optimizer, batch_size=auto_batch_size, seq_len=auto_seq_len,
                loss=loss, device=device)
            mesh = auto_lib.layout_mesh(layout)
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh (data and tensor parallel training) is not in the port yet "
                "(ROADMAP.md Queue A, A8b)")
        if pipeline_stages > 1:
            raise NotImplementedError(
                "pipeline stages are not in the port yet (ROADMAP.md Queue A, A9)")
        self.spec = spec
        self.optimizer = optimizer
        self.device = resolve_device(device)
        self.loss_name = loss
        self.loss_fn = loss_lib.LOSSES[loss]
        self.params = tree_map(_trainable(self.device), params)
        self.opt_state = optimizer.init(self.params)
        self.metrics = metrics_lib.PerfMetrics()

    def _as_tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return decoder.to_device(a, self.device)

    def _logits(self, tokens: torch.Tensor) -> torch.Tensor:
        b, t = tokens.shape
        positions = torch.arange(t, dtype=torch.int32, device=self.device)[None].expand(b, t)
        logits, _ = decoder.forward(self.spec, self.params, tokens, positions)
        return logits

    def train_step(self, tokens, labels) -> float:
        """One step on a [B, T] batch; returns its loss."""
        tokens, labels = self._as_tensor(tokens), self._as_tensor(labels)
        with torch.enable_grad():
            logits = self._logits(tokens)
            loss = self.loss_fn(logits, labels)
            loss.backward()
        grads = tree_map(lambda p: p.grad, self.params)
        self.params, self.opt_state = self.optimizer.update(grads, self.opt_state, self.params)
        for p, in zip_leaves(self.params):
            p.grad = None
        m = metrics_lib.classification_metrics(logits.detach(), labels)
        self.metrics.update({k: int(v) for k, v in m.items()})
        return float(loss.detach())

    def fit(self, data: Iterable[Tuple[np.ndarray, np.ndarray]], *, epochs: int = 1,
            log_every: int = 0, log_fn: Callable[[str], None] = print) -> list:
        """Keras-style fit over an iterable of (tokens, labels) batches."""
        history = []
        for epoch in range(epochs):
            t0, n = time.monotonic(), 0
            epoch_losses = []
            for tokens, labels in data:
                loss = self.train_step(tokens, labels)
                epoch_losses.append(loss)
                n += 1
                if log_every and n % log_every == 0:
                    log_fn(f"epoch {epoch} it {n}: loss={loss:.4f} "
                           f"acc={self.metrics.accuracy:.4f}")
            history.append({
                "epoch": epoch,
                "loss": float(np.mean(epoch_losses)) if epoch_losses else 0.0,
                "accuracy": self.metrics.accuracy,
                "seconds": time.monotonic() - t0,
            })
        return history

    @torch.no_grad()
    def evaluate(self, data: Iterable[Tuple[np.ndarray, np.ndarray]]) -> dict:
        total, count, correct, n = 0.0, 0, 0, 0
        for tokens, labels in data:
            tokens, labels = self._as_tensor(tokens), self._as_tensor(labels)
            logits = self._logits(tokens)
            total += float(self.loss_fn(logits, labels))
            m = metrics_lib.classification_metrics(logits, labels)
            count += int(m["count"])
            correct += int(m["correct"])
            n += 1
        return {"loss": total / max(n, 1), "accuracy": correct / max(count, 1)}
