#!/usr/bin/env python
"""AlexNet on synthetic data — mirror of the reference training example
(examples/cpp/AlexNet, examples/python/native/alexnet.py)."""

import numpy as np

from flexflow_tpu_torch.ffmodel import AdamOptimizer, FFModel


def build_alexnet(ff: FFModel, batch_size: int, num_classes: int = 10):
    t = ff.create_tensor((batch_size, 3, 224, 224))
    t = ff.conv2d(t, 64, 11, 11, 4, 4, 2, 2, activation="relu")
    t = ff.pool2d(t, 3, 3, 2, 2)
    t = ff.conv2d(t, 192, 5, 5, 1, 1, 2, 2, activation="relu")
    t = ff.pool2d(t, 3, 3, 2, 2)
    t = ff.conv2d(t, 384, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.pool2d(t, 3, 3, 2, 2)
    t = ff.flat(t)
    t = ff.dense(t, 4096, activation="relu")
    t = ff.dropout(t, 0.5)
    t = ff.dense(t, 4096, activation="relu")
    t = ff.dropout(t, 0.5)
    t = ff.dense(t, num_classes)
    return ff


def main(batch_size=8, epochs=1, samples=32, device=None):
    ff = FFModel(device=device)
    build_alexnet(ff, batch_size)
    ff.compile(optimizer=AdamOptimizer(lr=1e-3))
    rng = np.random.RandomState(0)
    x = rng.randn(samples, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 10, samples).astype(np.int32)
    hist = ff.fit(x, y, batch_size=batch_size, epochs=epochs)
    print("final:", hist[-1])


if __name__ == "__main__":
    main()
