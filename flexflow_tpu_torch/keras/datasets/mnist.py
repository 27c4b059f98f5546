"""MNIST loader (port of ``flexflow_tpu/keras/datasets/mnist.py``).

Reads ``mnist.npz`` from ``~/.keras/datasets`` (or ``$KERAS_HOME``) when
present and downloads nothing; ``load_data(synthetic=True)`` generates a
deterministic class-structured stand-in (the JAX package's, value for
value), so the examples and tests run without the file.
"""

from __future__ import annotations

import os

import numpy as np


def _cache_path(fname):
    home = os.environ.get("KERAS_HOME", os.path.expanduser("~/.keras"))
    return os.path.join(home, "datasets", fname)


def synthetic_classification(n, shape, num_classes, seed=0):
    """Deterministic linearly-separable-ish image classes."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, size=n).astype("int64")
    protos = rng.rand(num_classes, *shape).astype("float32")
    x = protos[y] * 255.0 * 0.6 + rng.rand(n, *shape).astype("float32") * 255.0 * 0.4
    return x.astype("uint8"), y


def load_data(path="mnist.npz", synthetic=False):
    full = _cache_path(path)
    if not synthetic and os.path.exists(full):
        with np.load(full, allow_pickle=True) as f:
            return (f["x_train"], f["y_train"]), (f["x_test"], f["y_test"])
    if not synthetic:
        raise FileNotFoundError(
            f"{full} not found (the loader downloads nothing); "
            "place mnist.npz there or call load_data(synthetic=True)"
        )
    xtr, ytr = synthetic_classification(512, (28, 28), 10, seed=0)
    xte, yte = synthetic_classification(128, (28, 28), 10, seed=1)
    return (xtr, ytr), (xte, yte)
