"""Co-scheduled LoRA finetuning (port of ``flexflow_tpu/peft/finetune.py``).

A finetuning session advances one optimizer step per scheduler iteration,
interleaved with serving (``RequestManager.register_finetune``). A step is
the decoder's forward (``flash=False``, its plain attention) with the
session's adapter on every row at ``lora_scale``, sparse cross entropy,
gradients for that adapter's A and B only, and an SGD or Adam update.

JAX's step rebinds ``engine.lora`` to new stacks. The port's engine holds
its adapters in the routing layout (``peft/lora.route_lora``), and its
captured CUDA graphs read those tensors by address, so a rebound stack
would be invisible to every replayed horizon. So the session trains views
of its slot's columns of the routed A ([L, D_in, r] of [L, D_in, N*r]) and
rows of the routed B, and the optimizer writes them in place: the next
forward or replay, in stream order, reads the updated adapter, and every
other slot keeps its bits. The losses stay on the device until read, so a
step waits for nothing on the host and pipelined horizons keep running
ahead.

On a mesh engine (``engine.shard``) the slot's views are the rank's cut
(``sharding.shard_lora``) and the forward runs the rank's tree through the
decoder's conjugate collectives. The gradients that are partial over a
group (``sharding.lora_partial_grads``: a column target's ``a``, over
``model`` or a hybrid FFN's group) are summed before the update; each rank updates its own cut. Every data rank
runs the same step on the same sequence (JAX computes the replicated step
once), so the adapters stay equal across data ranks, bit for bit. So does
every seq rank of an engine whose cache is cut on ``seq``: the step's
forward is the decoder's prefill, which never reads the cache's seq cut,
and no gradient is summed over ``seq``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.models import decoder
from flexflow_tpu_torch.parallel.mesh import all_reduce_grads
from flexflow_tpu_torch.parallel.sharding import lora_partial_grads
from flexflow_tpu_torch.peft.lora import LoraConfig, RoutedLora, lora_scaling
from flexflow_tpu_torch.specs import ModelSpec
from flexflow_tpu_torch.training.losses import sparse_categorical_crossentropy
from flexflow_tpu_torch.training.optimizers import AdamOptimizer, SGDOptimizer


class FinetuneSession:
    """One LoRA finetuning job over a token dataset (list of (tokens, labels),
    each [B, T])."""

    def __init__(self, spec: ModelSpec, config: LoraConfig, adapter_id: int,
                 data: List[Tuple[np.ndarray, np.ndarray]], *, epochs: int = 1,
                 max_steps: int = 0):
        """``max_steps`` > 0 caps the optimizer steps whatever epochs x the
        dataset size (the reference's --max-training-steps)."""
        self.spec = spec
        self.config = config
        self.adapter_id = adapter_id
        self.data = data
        self.epochs = epochs
        self.max_steps = int(max_steps)
        self._losses: List[torch.Tensor] = []
        self._cursor = 0
        self._opt = (AdamOptimizer(lr=config.learning_rate) if config.optimizer == "adam"
                     else SGDOptimizer(lr=config.learning_rate))
        self._opt_state = None
        self.params: Optional[dict] = None  # {module: {"a", "b"}}: views of the engine's slot
        self._shard = None  # the engine's Shard (a mesh engine's)

    @property
    def losses(self) -> List[float]:
        """Each step's loss (read from the device)."""
        return torch.stack(self._losses).tolist() if self._losses else []

    def _build(self, engine) -> None:
        mesh = getattr(engine, "mesh", None)
        if mesh is not None and mesh.pipe > 1:
            raise NotImplementedError(
                "finetuning on a pipeline engine: its layers are cut into stages, and JAX's "
                "FinetuneSession cannot run on its PipelineInferenceEngine either (it runs "
                "decoder.forward on that engine's [P, L/P, ...] stage-stacked layers and fails)")
        if engine.lora is None:
            raise ValueError("the engine holds no LoRA adapters")
        lora: RoutedLora = engine.lora
        s, r = self.adapter_id, lora.rank
        if not 0 <= s < lora.num_adapters:
            raise ValueError(f"adapter {s}: the engine holds {lora.num_adapters} adapters")
        self.params = {m: {"a": lora.a[m][:, :, s * r:(s + 1) * r].detach().requires_grad_(),
                           "b": lora.b[m][:, s * r:(s + 1) * r].detach().requires_grad_()}
                       for m in lora.a}
        self._opt_state = self._opt.init(self.params)
        self._shard = engine.shard

    def loss(self, engine, tokens, labels) -> torch.Tensor:
        """The forward of one step on a (tokens, labels) batch: the loss, with
        its graph to the session's slot (``self.params``)."""
        if self.params is None:
            self._build(engine)
        tokens = decoder.to_device(tokens, engine.device)
        labels = decoder.to_device(labels, engine.device)
        b, t = tokens.shape
        positions = torch.arange(t, dtype=torch.int32, device=engine.device)[None].expand(b, t)
        routed = RoutedLora({m: ab["a"] for m, ab in self.params.items()},
                            {m: ab["b"] for m, ab in self.params.items()},
                            engine.lora.rank, 1)
        with torch.enable_grad():
            logits, _ = decoder.forward(
                self.spec, engine.params, tokens, positions, lora=routed,
                adapter_ids=torch.zeros(b, dtype=torch.int64, device=engine.device),
                lora_scale=lora_scaling(self.config), shard=engine.shard)
            return sparse_categorical_crossentropy(logits, labels)

    def update(self) -> None:
        """The optimizer step from the gradients in ``self.params`` (in place
        on the engine's slot); the gradients are dropped after it."""
        grads = {m: {k: p.grad for k, p in ab.items()} for m, ab in self.params.items()}
        partial: dict = {}  # group -> the gradients partial over it
        for m, k, axis in lora_partial_grads(self._shard):
            if m in grads and grads[m][k] is not None:
                partial.setdefault(axis, []).append(grads[m][k])
        for axis, gs in partial.items():
            all_reduce_grads(gs, self._shard.mesh, axis)
        self._opt.update(grads, self._opt_state, self.params)
        for ab in self.params.values():
            for p in ab.values():
                p.grad = None

    def tick(self, engine) -> bool:
        """Run one finetuning step on the engine's live adapters. Returns True
        when the session has finished."""
        total = len(self.data) * self.epochs
        if self.max_steps > 0:
            total = min(total, self.max_steps)
        if self._cursor >= total:
            return True
        loss = self.loss(engine, *self.data[self._cursor % len(self.data)])
        loss.backward()
        self.update()
        self._losses.append(loss.detach())
        self._cursor += 1
        return self._cursor >= total
