"""Keras Sequential / functional Model over the FFModel DSL (port of
``flexflow_tpu/keras/models.py``). A model lives on one device: ``cuda``
unless ``InputTensor`` / ``Sequential`` are given another; ``fit``,
``evaluate`` and ``predict`` run there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import torch

from flexflow_tpu_torch.ffmodel import FFModel
from flexflow_tpu_torch.keras.layers import Input, Layer

_LOSS_MAP = {
    "sparse_categorical_crossentropy": "sparse_categorical_crossentropy",
    "categorical_crossentropy": "categorical_crossentropy",
    "mean_squared_error": "mean_squared_error",
    "mse": "mean_squared_error",
}


class _Builder:
    def __init__(self, ff: FFModel):
        self.ff = ff


@dataclasses.dataclass
class KTensor:
    """Symbolic Keras tensor: (builder, underlying DSL tensor)."""

    builder: _Builder
    sym: Any

    @property
    def shape(self):
        return self.sym.shape


def InputTensor(shape, batch_size=32, dtype=torch.float32, builder=None, device=None):
    """Functional-API entry: a fresh graph input, on ``builder``'s model or a
    new one on ``device``."""
    if builder is None:
        builder = _Builder(FFModel(device=device))
    sym = builder.ff.create_tensor((batch_size,) + tuple(shape), dtype)
    return KTensor(builder, sym)


class Model:
    """Functional model: Model(inputs=[...], outputs=out_tensor)."""

    def __init__(self, inputs, outputs, name: str = ""):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self.ff = inputs[0].builder.ff
        self.name = name

    def compile(self, optimizer=None, loss="sparse_categorical_crossentropy",
                metrics=("accuracy",), auto_parallel=False):
        """``auto_parallel=True`` runs ``FFModel.compile``'s joint rewrite x
        placement search; over the ranks of a ``torch.distributed`` world
        the first ``fit`` batch then runs the measured (data, model) search
        and trains the chosen cut (``FFModel._auto_parallelize``)."""
        self.ff.compile(optimizer=optimizer, loss_type=_LOSS_MAP[loss],
                        metrics=metrics, auto_parallel=auto_parallel)

    @property
    def ffmodel(self):
        """The underlying FFModel."""
        return self.ff

    @property
    def optimizer(self):
        return self.ff.optimizer

    def fit(self, x, y, batch_size=32, epochs=1, shuffle=True, verbose=0,
            callbacks=None):
        """Training loop with keras callbacks, driven per epoch."""
        if not callbacks:
            return self.ff.fit(x, y, batch_size=batch_size, epochs=epochs,
                               shuffle=shuffle)
        from flexflow_tpu_torch.keras.callbacks import CallbackList

        cbs = CallbackList(callbacks)
        cbs.set_model(self)
        cbs.set_params({"epochs": epochs, "batch_size": batch_size})
        cbs.on_train_begin()
        history = []
        for epoch in range(epochs):
            cbs.on_epoch_begin(epoch)
            [h] = self.ff.fit(x, y, batch_size=batch_size, epochs=1,
                              shuffle=shuffle)
            h = dict(h, epoch=epoch)
            history.append(h)
            stop = any(bool(r) for r in cbs.on_epoch_end(epoch, logs=h))
            if stop:
                break
        cbs.on_train_end()
        return history

    def evaluate(self, x, y, batch_size=32):
        return self.ff.evaluate(x, y, batch_size=batch_size)

    def predict(self, x):
        return self.ff.forward(x)

    def summary(self) -> str:
        lines = [f"Model: {self.name or 'model'}"]
        for n in self.ff._nodes:
            lines.append(f"  {n.name:<24} {n.op:<14} -> {n.out_shapes}")
        return "\n".join(lines)


class Sequential(Model):
    """Sequential stack, built at ``compile`` on ``device``."""

    def __init__(self, layers: Optional[Sequence] = None, name: str = "", device=None):
        self._layers: List = []
        self._input_spec: Optional[Input] = None
        self.name = name
        self.device = device
        self.ff = None
        for layer in layers or []:
            self.add(layer)

    def add(self, layer):
        if isinstance(layer, Input):
            self._input_spec = layer
        else:
            self._layers.append(layer)

    def _build(self):
        if self._input_spec is None:
            raise ValueError("add an Input(...) first")
        ff = FFModel(device=self.device)
        t = ff.create_tensor(
            (self._input_spec.batch_size,) + tuple(self._input_spec.shape),
            self._input_spec.dtype,
        )
        for layer in self._layers:
            if not isinstance(layer, Layer):
                raise TypeError(f"not a layer: {layer!r}")
            t = layer.build(ff, t)
        self.ff = ff

    def compile(self, optimizer=None, loss="sparse_categorical_crossentropy",
                metrics=("accuracy",), auto_parallel=False):
        if self.ff is None:
            self._build()
        super().compile(optimizer=optimizer, loss=loss, metrics=metrics,
                        auto_parallel=auto_parallel)
