#!/usr/bin/env python
"""Two-tower MLP (reference examples/cpp/MLP_Unify/mlp.cc).

Two input towers, each a deep bias-free dense stack with relu between
layers, summed and softmaxed — the Unity paper's co-optimization demo
workload. Scaled-down dims for a CPU smoke; pass --full for the reference
8x8192 stack on real hardware.

``--auto-parallelism`` plans the graph with the joint search; under
``torchrun`` (one process a GPU) the first batch then runs the measured
(data, model) search over the ranks and every rank trains its cut
(``FFModel.fit``); rank 0 prints.
"""

import argparse

import numpy as np
import torch.distributed as dist

from flexflow_tpu_torch.ffmodel import FFModel
from flexflow_tpu_torch.training import SGDOptimizer


def build(ff: FFModel, batch: int, in_dim: int, hidden) -> FFModel:
    t1 = ff.create_tensor((batch, in_dim))
    t2 = ff.create_tensor((batch, in_dim))
    for i, h in enumerate(hidden):
        act = None if i + 1 == len(hidden) else "relu"
        t1 = ff.dense(t1, h, activation=act, use_bias=False)
        t2 = ff.dense(t2, h, activation=act, use_bias=False)
    ff.softmax(ff.add(t1, t2))
    return ff


def main(argv=None, device=None):
    p = argparse.ArgumentParser()
    p.add_argument("--full", action="store_true",
                   help="reference dims (1024 -> 8x8192)")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--auto-parallelism", action="store_true")
    args = p.parse_args(argv)

    batch = 64 if args.full else 16
    in_dim = 1024 if args.full else 32
    hidden = [8192] * 8 if args.full else [64, 64, 10]

    ff = build(FFModel(device=device), batch, in_dim, hidden)
    ff.compile(SGDOptimizer(lr=0.001), auto_parallel=args.auto_parallelism)

    rng = np.random.RandomState(0)
    n = 4 * batch
    x1 = rng.randn(n, in_dim).astype(np.float32)
    x2 = rng.randn(n, in_dim).astype(np.float32)
    y = rng.randint(0, hidden[-1], size=(n,)).astype(np.int32)
    hist = ff.fit([x1, x2], y, batch_size=batch, epochs=args.epochs)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print("final:", hist[-1])
    return hist


if __name__ == "__main__":
    main()
