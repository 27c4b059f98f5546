#!/usr/bin/env python
"""Hand-built multi-head attention demo (reference
examples/python/native/multi_head_attention.py): dense Q/K/V +
reshape/transpose + batch_matmul, trained on a synthetic regression
target with MSE loss.
"""

import numpy as np

from flexflow_tpu_torch.ffmodel import FFModel
from flexflow_tpu_torch.training import SGDOptimizer


def build(ff: FFModel, batch=8, seq=16, hidden=64, heads=4) -> FFModel:
    x = ff.create_tensor((batch, seq, hidden))
    q = ff.dense(x, hidden)
    k = ff.dense(x, hidden)
    v = ff.dense(x, hidden)
    hd = hidden // heads
    q = ff.transpose(ff.reshape(q, (batch, seq, heads, hd)), (0, 2, 1, 3))
    k = ff.transpose(ff.reshape(k, (batch, seq, heads, hd)), (0, 2, 3, 1))
    v = ff.transpose(ff.reshape(v, (batch, seq, heads, hd)), (0, 2, 1, 3))
    logits = ff.batch_matmul(q, k)
    out = ff.batch_matmul(ff.softmax(logits), v)
    out = ff.reshape(ff.transpose(out, (0, 2, 1, 3)), (batch, seq, hidden))
    ff.dense(out, hidden)
    return ff


def main(epochs: int = 2, batch: int = 8, seq: int = 16, hidden: int = 64, device=None):
    ff = build(FFModel(device=device), batch, seq, hidden)
    ff.compile(SGDOptimizer(lr=0.01), loss_type="mean_squared_error",
               metrics=("mean_squared_error",))
    rng = np.random.RandomState(0)
    n = 4 * batch
    x = rng.randn(n, seq, hidden).astype(np.float32)
    y = np.roll(x, 1, axis=1)  # learn a shift map
    hist = ff.fit(x, y, batch_size=batch, epochs=epochs)
    print("final:", hist[-1])
    return hist


if __name__ == "__main__":
    main()
