#!/usr/bin/env python
"""MLP on synthetic MNIST-shaped data (reference examples/python/native/mnist_mlp.py)."""

import numpy as np

import flexflow_tpu_torch.keras as keras
from flexflow_tpu_torch.keras import Dense, Input, Sequential


def main(device=None):
    rng = np.random.RandomState(0)
    x = rng.randn(512, 784).astype(np.float32)
    y = (x[:, :10].argmax(-1)).astype(np.int32)

    model = Sequential(device=device, layers=[
        Input(shape=(784,), batch_size=64),
        Dense(512, activation="relu"),
        Dense(512, activation="relu"),
        Dense(10),
    ])
    model.compile(optimizer=keras.SGD(learning_rate=0.01, momentum=0.9),
                  loss="sparse_categorical_crossentropy")
    hist = model.fit(x, y, batch_size=64, epochs=5)
    print("final:", hist[-1])
    print(model.evaluate(x, y, batch_size=64))


if __name__ == "__main__":
    main()
