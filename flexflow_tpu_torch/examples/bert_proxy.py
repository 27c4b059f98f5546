#!/usr/bin/env python
"""BERT-proxy via the FFModel DSL (reference
examples/python/native/bert_proxy_native.py): hand-built MHA from
dense/reshape/transpose/batch_matmul, residual adds, gelu dense stacks.

Scaled-down dims for the CPU smoke; --large uses the reference's
BERT-large geometry.
"""

import argparse

import numpy as np

from flexflow_tpu_torch.ffmodel import FFModel
from flexflow_tpu_torch.training import SGDOptimizer


def mha(model, q, k, v, batch, seq, hidden, heads, kdim, vdim):
    q = model.dense(q, hidden)
    k = model.dense(k, hidden)
    v = model.dense(v, hidden)
    q = model.reshape(q, (batch, seq, heads, kdim))
    k = model.reshape(k, (batch, seq, heads, kdim))
    v = model.reshape(v, (batch, seq, heads, vdim))
    q = model.transpose(q, (0, 2, 1, 3))
    k = model.transpose(k, (0, 2, 3, 1))
    v = model.transpose(v, (0, 2, 1, 3))
    logits = model.batch_matmul(q, k)
    out = model.batch_matmul(model.softmax(logits), v)
    out = model.transpose(out, (0, 2, 1, 3))
    out = model.reshape(out, (batch, seq, hidden))
    return model.dense(out, hidden, activation="gelu")


def bert_layer(model, x, batch, seq, hidden, heads, kdim, vdim):
    t = mha(model, x, x, x, batch, seq, hidden, heads, kdim, vdim)
    t = model.dense(t, hidden, activation="gelu")
    t = model.add(t, x)
    inter = model.dense(t, hidden, activation="gelu")
    t = model.dense(inter, hidden, activation="gelu")
    return model.add(t, inter)


def build(ff, batch, seq, hidden, heads, layers, classes=8):
    x = ff.create_tensor((batch, seq, hidden))
    t = x
    kdim = vdim = hidden // heads
    for _ in range(layers):
        t = bert_layer(ff, t, batch, seq, hidden, heads, kdim, vdim)
    t = ff.dense(ff.mean(t, [1]), classes)
    ff.softmax(t)
    return ff


def main(argv=None, device=None):
    p = argparse.ArgumentParser()
    p.add_argument("--large", action="store_true",
                   help="reference BERT-large dims (512/16/1024/24)")
    p.add_argument("--epochs", type=int, default=1)
    args = p.parse_args(argv)

    batch = 4
    seq, heads, hidden, layers = (
        (512, 16, 1024, 24) if args.large else (16, 4, 64, 2))
    ff = build(FFModel(device=device), batch, seq, hidden, heads, layers)
    ff.compile(SGDOptimizer(lr=0.01))
    rng = np.random.RandomState(0)
    n = 4 * batch
    x = rng.randn(n, seq, hidden).astype(np.float32)
    y = rng.randint(0, 8, size=(n,)).astype(np.int32)
    hist = ff.fit(x, y, batch_size=batch, epochs=args.epochs)
    print("final:", hist[-1])
    return hist


if __name__ == "__main__":
    main()
