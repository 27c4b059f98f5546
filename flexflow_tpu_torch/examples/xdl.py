#!/usr/bin/env python
"""XDL CTR model — mirror of the reference training example
(examples/cpp/XDL/xdl.cc): sparse-feature embedding bags
concatenated with a dense-feature MLP bottom, through an MLP top to a
2-class click prediction."""

import numpy as np

from flexflow_tpu_torch.ffmodel import FFModel, SGDOptimizer

SPARSE_FEATURES = 4
EMB_SIZE = 1000  # reference uses 1e6-entry tables; scaled for the smoke path
SPARSE_DIM = 64
DENSE_IN = 16
MLP_TOP = (256, 256, 2)


def build_xdl(ff: FFModel, batch_size: int):
    dense = ff.create_tensor((batch_size, DENSE_IN))
    embs = []
    for _ in range(SPARSE_FEATURES):
        ids = ff.create_tensor((batch_size, 1), np.int32)
        embs.append(ff.flat(ff.embedding(ids, EMB_SIZE, SPARSE_DIM)))
    t = ff.concat(embs + [ff.dense(dense, SPARSE_DIM, activation="relu")],
                  axis=1)
    for i, d in enumerate(MLP_TOP):
        t = ff.dense(t, d, activation="relu" if i < len(MLP_TOP) - 1 else None)
    return ff


def main(batch_size=16, epochs=1, samples=64, device=None):
    ff = FFModel(device=device)
    build_xdl(ff, batch_size)
    ff.compile(optimizer=SGDOptimizer(lr=0.01))
    rng = np.random.RandomState(0)
    xs = [rng.randint(0, EMB_SIZE, size=(samples, 1)).astype(np.int32)
          for _ in range(SPARSE_FEATURES)]
    dense = rng.randn(samples, DENSE_IN).astype(np.float32)
    y = rng.randint(0, 2, samples).astype(np.int32)
    hist = ff.fit([dense] + xs, y, batch_size=batch_size, epochs=epochs)
    print("final:", hist[-1])
    return hist


if __name__ == "__main__":
    main()
