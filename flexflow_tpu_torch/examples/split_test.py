#!/usr/bin/env python
"""Concat/split CNN (reference examples/python/native/split.py).

Three parallel conv towers concatenated on channels, split back apart, and
only the MIDDLE split branch carried forward — exercises multi-output ops
and partial-consumer dataflow (the substitution engine must keep the split
alive while eliminating nothing it shouldn't).
"""

import numpy as np

from flexflow_tpu_torch.ffmodel import FFModel
from flexflow_tpu_torch.training import SGDOptimizer


def build(ff: FFModel, batch: int = 8) -> FFModel:
    x = ff.create_tensor((batch, 3, 32, 32))
    t1 = ff.conv2d(x, 32, 3, 3, 1, 1, 1, 1, activation="relu")
    t2 = ff.conv2d(x, 32, 3, 3, 1, 1, 1, 1, activation="relu")
    t3 = ff.conv2d(x, 32, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.concat([t1, t2, t3], axis=1)
    ts = ff.split(t, [32, 32, 32], axis=1)
    t = ff.conv2d(ts[1], 32, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0)
    t = ff.conv2d(t, 64, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.conv2d(t, 64, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0)
    t = ff.flat(t)
    t = ff.dense(t, 512, activation="relu")
    t = ff.dense(t, 10)
    ff.softmax(t)
    return ff


def main(epochs: int = 1, batch: int = 8, device=None):
    ff = build(FFModel(device=device), batch)
    ff.compile(SGDOptimizer(lr=0.01))
    rng = np.random.RandomState(0)
    n = 4 * batch
    x = rng.randn(n, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, size=(n,)).astype(np.int32)
    hist = ff.fit(x, y, batch_size=batch, epochs=epochs)
    print("final:", hist[-1])
    return hist


if __name__ == "__main__":
    main()
