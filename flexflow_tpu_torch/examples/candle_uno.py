#!/usr/bin/env python
"""CANDLE-UNO drug-response model — mirror of the reference training example
(examples/cpp/candle_uno/candle_uno.cc): per-input-feature
towers of dense layers, concatenated, then a deep dense trunk."""

import numpy as np

from flexflow_tpu_torch.ffmodel import AdamOptimizer, FFModel

FEATURE_INPUTS = 3  # gene expression / drug descriptors / drug fingerprints
FEATURE_DIM = 64
FEATURE_LAYERS = (128, 128)  # reference: 4192x3 (scaled for the smoke path)
TRUNK_LAYERS = (256, 256, 1)


def build_candle_uno(ff: FFModel, batch_size: int):
    towers = []
    for _ in range(FEATURE_INPUTS):
        t = ff.create_tensor((batch_size, FEATURE_DIM))
        for d in FEATURE_LAYERS:
            t = ff.dense(t, d, activation="relu", use_bias=False)
        towers.append(t)
    t = ff.concat(towers, axis=1)
    for i, d in enumerate(TRUNK_LAYERS):
        act = "relu" if i < len(TRUNK_LAYERS) - 1 else None
        t = ff.dense(t, d, activation=act, use_bias=False)
    return ff


def main(batch_size=16, epochs=1, samples=64, device=None):
    ff = FFModel(device=device)
    build_candle_uno(ff, batch_size)
    ff.compile(optimizer=AdamOptimizer(lr=1e-3), loss_type="mean_squared_error",
               metrics=("mean_squared_error",))
    rng = np.random.RandomState(0)
    xs = [rng.randn(samples, FEATURE_DIM).astype(np.float32)
          for _ in range(FEATURE_INPUTS)]
    y = rng.randn(samples, 1).astype(np.float32)
    hist = ff.fit(xs, y, batch_size=batch_size, epochs=epochs)
    print("final:", hist[-1])
    return hist


if __name__ == "__main__":
    main()
