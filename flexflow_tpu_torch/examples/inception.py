#!/usr/bin/env python
"""InceptionV3-style CNN — mirror of the reference training example
(examples/cpp/InceptionV3/inception.cc): stacked inception
blocks (parallel 1x1 / 3x3 / 5x5 / pool towers concatenated on channels).
Reduced input resolution so the smoke-test path stays fast; the block
structure matches the reference graph builder.
"""

import numpy as np

from flexflow_tpu_torch.ffmodel import AdamOptimizer, FFModel


def inception_block(ff, t, c1, c3r, c3, c5r, c5, cp):
    """Four towers concatenated on the channel axis (inception.cc InceptionA)."""
    t1 = ff.conv2d(t, c1, 1, 1, activation="relu")
    t3 = ff.conv2d(t, c3r, 1, 1, activation="relu")
    t3 = ff.conv2d(t3, c3, 3, 3, 1, 1, 1, 1, activation="relu")
    t5 = ff.conv2d(t, c5r, 1, 1, activation="relu")
    t5 = ff.conv2d(t5, c5, 5, 5, 1, 1, 2, 2, activation="relu")
    tp = ff.pool2d(t, 3, 3, 1, 1, 1, 1, pool_type="avg")
    tp = ff.conv2d(tp, cp, 1, 1, activation="relu")
    return ff.concat([t1, t3, t5, tp], axis=1)


def build_inception(ff: FFModel, batch_size: int, num_classes: int = 10):
    t = ff.create_tensor((batch_size, 3, 32, 32))
    t = ff.conv2d(t, 32, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.pool2d(t, 2, 2, 2, 2)
    t = inception_block(ff, t, 16, 24, 32, 4, 8, 8)
    t = inception_block(ff, t, 32, 32, 48, 8, 16, 16)
    t = ff.pool2d(t, 2, 2, 2, 2)
    t = inception_block(ff, t, 48, 48, 64, 12, 24, 24)
    t = ff.pool2d(t, 8, 8, 8, 8, pool_type="avg")
    t = ff.flat(t)
    t = ff.dense(t, num_classes)
    return ff


def main(batch_size=8, epochs=1, samples=32, device=None):
    ff = FFModel(device=device)
    build_inception(ff, batch_size)
    ff.compile(optimizer=AdamOptimizer(lr=1e-3))
    rng = np.random.RandomState(0)
    x = rng.randn(samples, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, samples).astype(np.int32)
    hist = ff.fit(x, y, batch_size=batch_size, epochs=epochs)
    print("final:", hist[-1])
    return hist


if __name__ == "__main__":
    main()
