#!/usr/bin/env python
"""ResNet-18-style residual CNN (reference examples/cpp/ResNet, resnext50)."""

import numpy as np

from flexflow_tpu_torch.ffmodel import AdamOptimizer, FFModel


def basic_block(ff, t, channels, stride=1):
    shortcut = t
    out = ff.conv2d(t, channels, 3, 3, stride, stride, 1, 1)
    out = ff.batch_norm(out, relu=True)
    out = ff.conv2d(out, channels, 3, 3, 1, 1, 1, 1)
    out = ff.batch_norm(out, relu=False)
    if stride != 1 or shortcut.shape[1] != channels:
        shortcut = ff.conv2d(shortcut, channels, 1, 1, stride, stride, 0, 0)
        shortcut = ff.batch_norm(shortcut, relu=False)
    return ff.relu(ff.add(out, shortcut))


def build_resnet(ff, batch_size, num_classes=10, width=16, img=32):
    t = ff.create_tensor((batch_size, 3, img, img))
    t = ff.conv2d(t, width, 3, 3, 1, 1, 1, 1)
    t = ff.batch_norm(t, relu=True)
    for channels, stride in [(width, 1), (width, 1),
                             (2 * width, 2), (2 * width, 1),
                             (4 * width, 2), (4 * width, 1)]:
        t = basic_block(ff, t, channels, stride)
    t = ff.pool2d(t, t.shape[2], t.shape[3], 1, 1, pool_type="avg")
    t = ff.flat(t)
    t = ff.dense(t, num_classes)
    return ff


def main(batch_size=16, epochs=2, samples=64, device=None):
    ff = FFModel(device=device)
    build_resnet(ff, batch_size)
    ff.compile(optimizer=AdamOptimizer(lr=1e-3))
    rng = np.random.RandomState(0)
    x = rng.randn(samples, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, samples).astype(np.int32)
    hist = ff.fit(x, y, batch_size=batch_size, epochs=epochs)
    print("final:", hist[-1])


if __name__ == "__main__":
    main()
