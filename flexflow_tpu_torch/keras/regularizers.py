"""Keras regularizers (port of ``flexflow_tpu/keras/regularizers.py``).

Attached to layers via ``kernel_regularizer=``; the FFModel training step
adds the penalty to the loss (FFModel.set_regularizer).
"""

from __future__ import annotations


class Regularizer:
    l1: float = 0.0
    l2: float = 0.0


class L1(Regularizer):
    def __init__(self, l1: float = 0.01):
        self.l1 = float(l1)
        self.l2 = 0.0


class L2(Regularizer):
    def __init__(self, l2: float = 0.01):
        self.l1 = 0.0
        self.l2 = float(l2)


class L1L2(Regularizer):
    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1 = float(l1)
        self.l2 = float(l2)


def get(identifier):
    if identifier is None or isinstance(identifier, Regularizer):
        return identifier
    return {"l1": L1(), "l2": L2(), "l1_l2": L1L2(0.01, 0.01)}[identifier]
