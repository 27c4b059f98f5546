"""Keras callbacks (port of ``flexflow_tpu/keras/callbacks.py``).

The training loop (``keras.Model.fit``) drives these per epoch:
LearningRateScheduler, VerifyMetrics and EpochVerifyMetrics (FlexFlow's
set), History and EarlyStopping.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


class Callback:
    """Base class (reference callbacks.py:21)."""

    def __init__(self):
        self.validation_data = None
        self.model = None
        self.params = None

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, batch, logs=None):
        pass

    def on_batch_end(self, batch, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def fire(*a, **kw):
                results = [getattr(cb, name)(*a, **kw) for cb in self.callbacks]
                return results
            return fire
        raise AttributeError(name)


class LearningRateScheduler(Callback):
    """Per-epoch learning-rate schedule (reference callbacks.py:49)."""

    def __init__(self, schedule: Callable[[int], float]):
        super().__init__()
        self.schedule = schedule

    def on_epoch_begin(self, epoch, logs=None):
        if not hasattr(self.model.optimizer, "lr"):
            raise ValueError('Optimizer must have a "lr" attribute.')
        lr = self.schedule(epoch)
        if not isinstance(lr, (float, np.float32, np.float64)):
            raise ValueError(
                'The output of the "schedule" function should be float.'
            )
        self.model.ffmodel.set_learning_rate(lr)


class VerifyMetrics(Callback):
    """Assert final accuracy above a bar (reference callbacks.py:64 — the
    convergence gate used by examples/python accuracy tests)."""

    def __init__(self, accuracy: float):
        super().__init__()
        self.accuracy = getattr(accuracy, "value", accuracy)

    def on_train_end(self, logs=None):
        acc = self.model.ffmodel.metrics.accuracy
        if acc < self.accuracy:
            raise AssertionError(f"accuracy {acc:.4f} below the {self.accuracy} gate")


class EpochVerifyMetrics(Callback):
    """Early-stop when accuracy crosses a bar (reference callbacks.py:75)."""

    def __init__(self, accuracy: float, early_stop: bool = True):
        super().__init__()
        self.accuracy = getattr(accuracy, "value", accuracy)
        self.early_stop = early_stop

    def on_epoch_end(self, epoch, logs=None):
        acc = self.model.ffmodel.metrics.accuracy
        return bool(self.early_stop and acc >= self.accuracy)


class History(Callback):
    def on_train_begin(self, logs=None):
        self.history = {}

    def on_epoch_end(self, epoch, logs=None):
        for k, v in (logs or {}).items():
            self.history.setdefault(k, []).append(v)


class EarlyStopping(Callback):
    """Stop when the monitored value stops improving."""

    def __init__(self, monitor="loss", min_delta=0.0, patience=0):
        super().__init__()
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.best = np.inf
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return False
        if cur < self.best - self.min_delta:
            self.best = cur
            self.wait = 0
            return False
        self.wait += 1
        return self.wait > self.patience
