"""CIFAR-10 loader (port of ``flexflow_tpu/keras/datasets/cifar10.py``); see
mnist.py for where it reads and ``synthetic=True``."""

from __future__ import annotations

import os
import pickle

import numpy as np

from flexflow_tpu_torch.keras.datasets.mnist import _cache_path, synthetic_classification


def load_data(synthetic=False):
    root = _cache_path("cifar-10-batches-py")
    if not synthetic and os.path.isdir(root):
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(root, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"].reshape(-1, 3, 32, 32))
            ys.extend(d[b"labels"])
        x_train = np.concatenate(xs)
        y_train = np.asarray(ys, "int64")
        with open(os.path.join(root, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        return (x_train, y_train), (
            d[b"data"].reshape(-1, 3, 32, 32),
            np.asarray(d[b"labels"], "int64"),
        )
    if not synthetic:
        raise FileNotFoundError(
            f"{root} not found (the loader downloads nothing); "
            "place the CIFAR-10 python batches there or pass synthetic=True"
        )
    xtr, ytr = synthetic_classification(512, (3, 32, 32), 10, seed=0)
    xte, yte = synthetic_classification(128, (3, 32, 32), 10, seed=1)
    return (xtr, ytr), (xte, yte)
