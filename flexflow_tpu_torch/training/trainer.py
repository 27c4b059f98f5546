"""Trainer: train and eval steps and the fit loop, on one device or over a
``data x model`` mesh (port of ``flexflow_tpu/training/trainer.py``).

JAX jits one program per step (forward, ``value_and_grad``, the optimizer
update, metrics). Here a step runs eagerly: ``decoder.forward`` (its plain
attention; ``flash=True`` is inference-only in both packages), the loss,
``backward()``, and the optimizer's in-place update. The parameters are the
JAX package's unfused tree, copied once into leaf tensors that require
grad on the Trainer's device.

Quantized parameters are refused (``TypeError``): JAX cannot take a
gradient of integer leaves either. ``mesh="auto"`` runs the layout search
(``parallel/auto.optimize_train_layout``; its report is ``auto_report``)
over the ranks of the default process group, every rank alike: a Trainer
a candidate layout, each on copies of the parameters, timed on synthetic
tokens; then this Trainer trains from the given parameters under the
chosen layout's mesh, stages and microbatches (on one device: no mesh).

``mesh=`` a ``parallel/mesh.Mesh`` (JAX: Megatron shardings for the
parameters, ``P("data")`` for the batch, GSPMD's gradient sums): each rank
trains its cut of the unfused float tree (``sharding.shard_params``) on its
data rank's rows of each global batch (``sharding.data_rows``; a
``SingleDataLoader(mesh=)`` batch is those rows already). The forward runs
the decoder's conjugate collectives, so after ``backward()`` a rank holds
its cut of the gradient of its rows' loss sum over the global count of
labels (``losses.LOSS_PARTS``): the replicated leaves whose gradient is
partial over ``model`` (``sharding.partial_grads``) are summed there, then
every gradient over ``data``, in float32, and the optimizer (elementwise)
updates the cut. The loss, ``evaluate`` and the metrics are global;
``full_params()`` gathers the whole tree.

Pipeline stages (``pipeline_stages=P``, JAX's: the mesh's ``pipe`` axis
must be P; a mesh with ``pipe > 1`` alone means P stages): each rank holds
its stage's layers and top leaves (and its tensor cut), and a step is
``parallel/pipeline.gpipe_step``: its data rank's rows cut into
``num_microbatches`` (default P) microbatches, the GPipe forward over the
stage hops, the loss on the last stage, the explicit backward; then the
gradient sums of every step (``model``, ``data``, and a tied
``embed_tokens`` over the first and last stages, each of which holds one
of its two uses) and this rank's update. The loss and metrics are the last
stage's, broadcast over ``pipe``.

A context degree (``seq > 1``; JAX shards the batch on ``data`` only and
the parameters by the tensor rules, so its GSPMD replicates the step over
``seq``): every seq rank trains the same rows of the same cut, and each
of the sums above runs over the groups of the rank's own seq coordinate,
so the loss is counted once and the ranks' parameters stay equal.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.device import resolve_device
from flexflow_tpu_torch.models import decoder
from flexflow_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_reduce_grads
from flexflow_tpu_torch.parallel.pipeline import gpipe_step
from flexflow_tpu_torch.parallel.sharding import (data_rows, gather_params, partial_grads,
                                                  shard_params, tree_shard)
from flexflow_tpu_torch.quant.weight_only import QuantizedArray
from flexflow_tpu_torch.specs import ModelSpec
from flexflow_tpu_torch.training import losses as loss_lib
from flexflow_tpu_torch.training import metrics as metrics_lib
from flexflow_tpu_torch.training.dataloader import RankRows
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
    """Causal-LM trainer on one device or one rank of a mesh."""

    def __init__(self, spec: ModelSpec, params: Any, optimizer, *, mesh=None,
                 pipeline_stages: int = 1, num_microbatches: Optional[int] = None,
                 loss: str = "sparse_categorical_crossentropy",
                 auto_batch_size: int = 8, auto_seq_len: int = 128, device=None):
        """``mesh="auto"`` measures the legal layouts' train steps at
        (``auto_batch_size``, ``auto_seq_len``) over the default group's
        ranks and trains under the fastest (its mesh, pipeline stages and
        microbatches); on one device that is no mesh."""
        self.auto_report = None
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh must be a mesh or 'auto', got {mesh!r}")
            from flexflow_tpu_torch.parallel import auto as auto_lib

            layout, self.auto_report = auto_lib.optimize_train_layout(
                spec, params, optimizer, batch_size=auto_batch_size, seq_len=auto_seq_len,
                loss=loss, device=device)
            mesh = auto_lib.layout_mesh(layout, device)
            pipeline_stages, num_microbatches = layout.pipe, layout.num_microbatches
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh or 'auto', got "
                            f"{type(mesh).__name__}")
        if pipeline_stages > 1 and (mesh is None or mesh.pipe != pipeline_stages):
            raise ValueError(f"pipeline_stages={pipeline_stages} needs a mesh whose pipe axis "
                             f"is {pipeline_stages}, got "
                             + ("no mesh" if mesh is None else f"pipe={mesh.pipe}"))
        self.stages = 1 if mesh is None else mesh.pipe
        self.num_microbatches = num_microbatches or self.stages
        self.tied = "lm_head" not in params
        self.spec = spec
        self.optimizer = optimizer
        self.mesh = mesh
        self.device = resolve_device(device if device is not None or mesh is None
                                     else mesh.device)
        self.loss_name = loss
        self.loss_fn = loss_lib.LOSSES[loss]
        self.loss_parts = loss_lib.LOSS_PARTS[loss]
        self.shard = None
        if mesh is not None:
            self.shard = tree_shard(spec, params, mesh)
            params = shard_params(spec, params, mesh)
        self.params = tree_map(_trainable(self.device), params)
        self._partial = [self.params["layers"][n] for n in partial_grads(self.shard)
                         if self.params["layers"].get(n) is not None]
        self.opt_state = optimizer.init(self.params)
        self.metrics = metrics_lib.PerfMetrics()

    def _as_tensor(self, a) -> torch.Tensor:
        """This data rank's rows of a global batch, on the device."""
        if not isinstance(a, RankRows):
            a = data_rows(a, self.mesh)
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return decoder.to_device(a, self.device)

    def _logits(self, tokens: torch.Tensor) -> torch.Tensor:
        b, t = tokens.shape
        positions = torch.arange(t, dtype=torch.int32, device=self.device)[None].expand(b, t)
        logits, _ = decoder.forward(self.spec, self.params, tokens, positions, shard=self.shard)
        return logits

    def _loss(self, logits, labels):
        """(the loss to differentiate: this rank's sum over the global count,
        and the global loss, detached)."""
        if self.mesh is None or self.mesh.data == 1:
            loss = self.loss_fn(logits, labels)
            return loss, loss.detach()
        total, count = self.loss_parts(logits, labels)
        whole, denom = self.mesh.all_reduce(
            torch.stack([total.detach().double(), count.double()]), DATA_AXIS)
        denom = denom.clamp_min(1)
        return total / denom.float(), (whole / denom).float()

    def _parts(self, logits, labels):
        """A microbatch's (loss sum, label count, metric counts)."""
        m = metrics_lib.classification_metrics(logits.detach(), labels)
        return (*self.loss_parts(logits, labels), m["count"], m["correct"])

    def _gpipe(self, tokens, labels, backward: bool) -> Tuple[float, dict]:
        """``gpipe_step`` on this rank: (the global loss, its metrics), the
        same on every rank."""
        stats = gpipe_step(self.spec, self.params, self.shard, tokens, labels, self._parts,
                           num_microbatches=self.num_microbatches, backward=backward)
        if stats is None:
            stats = torch.empty(4, dtype=torch.float64, device=self.device)
        total, count, n, correct = self.mesh.broadcast_from_stage(
            stats, self.mesh.pipe - 1).tolist()
        return total / max(count, 1), {"count": int(n), "correct": int(correct)}

    def train_step(self, tokens, labels) -> float:
        """One step on a [B, T] global batch (this rank's rows of it under a
        mesh); returns its loss."""
        tokens, labels = self._as_tensor(tokens), self._as_tensor(labels)
        if self.stages > 1:
            value, m = self._gpipe(tokens, labels, backward=True)
            self._sum_grads()
            self._update()
            self.metrics.update(m)
            return value
        with torch.enable_grad():
            logits = self._logits(tokens)
            loss, value = self._loss(logits, labels)
            loss.backward()
        self._sum_grads()
        self._update()
        m = metrics_lib.global_counts(
            metrics_lib.classification_metrics(logits.detach(), labels), self.mesh)
        self.metrics.update({k: int(v) for k, v in m.items()})
        return float(value)

    def _sum_grads(self) -> None:
        """This rank's gradient parts summed, in order: the leaves partial
        over ``model``, every leaf over ``data`` (float32), and a tied
        ``embed_tokens`` over the first and last stages."""
        if self._partial:
            all_reduce_grads([p.grad for p in self._partial], self.mesh, MODEL_AXIS)
        if self.mesh is not None and self.mesh.data > 1:
            all_reduce_grads([p.grad for p, in zip_leaves(self.params) if p.grad is not None],
                             self.mesh, DATA_AXIS)
        if self.tied and self.stages > 1 and "embed_tokens" in self.params:
            self.mesh.sum_first_last(self.params["embed_tokens"].grad)

    def _update(self) -> None:
        """The optimizer's in-place update of this rank's leaves from their
        gradients, which it then clears."""
        grads = tree_map(lambda p: p.grad, self.params)
        self.params, self.opt_state = self.optimizer.update(grads, self.opt_state, self.params)
        for p, in zip_leaves(self.params):
            p.grad = None

    def full_params(self):
        """The whole (one-device) parameter tree, detached: this rank's cut
        gathered over ``model`` (and its stage over ``pipe``) under a mesh
        (every rank calls it)."""
        params = tree_map(lambda p: p.detach(), self.params)
        return params if self.mesh is None else gather_params(self.spec, params, self.mesh)

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
            if self.stages > 1:
                value, m = self._gpipe(tokens, labels, backward=False)
            else:
                logits = self._logits(tokens)
                value = float(self._loss(logits, labels)[1])
                m = metrics_lib.global_counts(
                    metrics_lib.classification_metrics(logits, labels), self.mesh)
            total += value
            count += int(m["count"])
            correct += int(m["correct"])
            n += 1
        return {"loss": total / max(n, 1), "accuracy": correct / max(count, 1)}
