#!/usr/bin/env python
"""ResNeXt-style grouped-convolution CNN — mirror of the reference example
(examples/cpp/resnext50/resnext.cc): bottleneck blocks whose
3x3 conv uses cardinality groups. Reduced depth/resolution for the smoke
path; the block structure matches the reference builder."""

import numpy as np

from flexflow_tpu_torch.ffmodel import SGDOptimizer, FFModel


def resnext_block(ff, t, out_channels, stride, groups=8):
    """1x1 -> grouped 3x3 -> 1x1(2x) with projection shortcut
    (resnext.cc:17-35)."""
    shortcut = t
    b = ff.conv2d(t, out_channels, 1, 1, 1, 1, 0, 0, activation="relu")
    b = ff.conv2d(b, out_channels, 3, 3, stride, stride, 1, 1,
                  activation="relu", groups=groups)
    b = ff.conv2d(b, 2 * out_channels, 1, 1, 1, 1, 0, 0)
    if shortcut.shape != b.shape:
        shortcut = ff.conv2d(shortcut, 2 * out_channels, 1, 1, stride, stride)
    return ff.relu(ff.add(b, shortcut))


def build_resnext(ff: FFModel, batch_size: int, num_classes: int = 10):
    t = ff.create_tensor((batch_size, 3, 32, 32))
    t = ff.conv2d(t, 32, 3, 3, 1, 1, 1, 1, activation="relu")
    t = resnext_block(ff, t, 32, 1)
    t = resnext_block(ff, t, 32, 2)
    t = resnext_block(ff, t, 64, 2)
    t = ff.pool2d(t, 8, 8, 8, 8, pool_type="avg")
    t = ff.flat(t)
    t = ff.dense(t, num_classes)
    return ff


def main(batch_size=8, epochs=1, samples=16, device=None):
    ff = FFModel(device=device)
    build_resnext(ff, batch_size)
    ff.compile(optimizer=SGDOptimizer(lr=0.01))
    rng = np.random.RandomState(0)
    x = rng.randn(samples, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, samples).astype(np.int32)
    hist = ff.fit(x, y, batch_size=batch_size, epochs=epochs)
    print("final:", hist[-1])
    return hist


if __name__ == "__main__":
    main()
