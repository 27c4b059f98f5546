#!/usr/bin/env python
"""CIFAR-10 CNN (reference examples/python/native/cifar10_cnn.py).

Two conv-conv-pool blocks + dense head; data comes from
flexflow_tpu.keras.datasets.cifar10 (local cache or synthetic fallback,
like the reference's keras dataset loader).
"""

import numpy as np

from flexflow_tpu_torch.ffmodel import FFModel
from flexflow_tpu_torch.training import SGDOptimizer


def build(ff: FFModel, batch: int = 8) -> FFModel:
    x = ff.create_tensor((batch, 3, 32, 32))
    t = ff.conv2d(x, 32, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.conv2d(t, 32, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0)
    t = ff.conv2d(t, 64, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.conv2d(t, 64, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0)
    t = ff.flat(t)
    t = ff.dense(t, 512, activation="relu")
    t = ff.dense(t, 10)
    ff.softmax(t)
    return ff


def main(epochs: int = 1, batch: int = 8, samples: int = 32, device=None):
    from flexflow_tpu_torch.keras.datasets import cifar10

    (x_train, y_train), _ = cifar10.load_data(samples)
    x = (x_train.astype(np.float32) / 255.0)[:samples]
    y = y_train.reshape(-1).astype(np.int32)[:samples]
    ff = build(FFModel(device=device), batch)
    ff.compile(SGDOptimizer(lr=0.01))
    hist = ff.fit(x, y, batch_size=batch, epochs=epochs)
    print("final:", hist[-1])
    return hist


if __name__ == "__main__":
    main()
