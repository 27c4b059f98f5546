#!/usr/bin/env python
"""Mixture-of-Experts classifier — mirror of the reference MoE training
example (examples/cpp/mixture_of_experts/moe.cc: MNIST
classifier whose hidden layer is a top-k-gated expert ensemble, built from
the gate->topk->group_by->experts->aggregate composite, src/ops/moe.cc:20-60).

``main(mesh=...)`` takes a ``parallel/mesh.Mesh`` and passes it to
``FFModel``, which keeps it and shards nothing, exactly as the JAX
package's ``FFModel`` (its example's docstring says the expert stacks
shard; they do not there either): the model trains as without a mesh, on
``mesh.device`` unless ``device`` names another.
"""

import numpy as np

from flexflow_tpu_torch.ffmodel import AdamOptimizer, FFModel
from flexflow_tpu_torch.keras.datasets import mnist


def build_moe(ff: FFModel, batch_size: int, num_classes: int = 10,
              num_experts: int = 4, top_k: int = 2):
    t = ff.create_tensor((batch_size, 28 * 28))
    t = ff.dense(t, 128, activation="relu")
    # expert ensemble replaces the hidden dense layer (moe.cc:40-60)
    t = ff.moe(t, num_experts=num_experts, top_k=top_k,
               expert_hidden=64, out_dim=128)
    t = ff.dense(t, num_classes)
    return ff


def main(batch_size=16, epochs=2, samples=256, mesh=None, device=None):
    (x, y), _ = mnist.load_data(synthetic=True)
    x = (x[:samples].reshape(samples, -1) / 255.0).astype(np.float32)
    y = y[:samples].astype(np.int32)
    ff = FFModel(mesh=mesh, device=device)
    build_moe(ff, batch_size)
    ff.compile(optimizer=AdamOptimizer(lr=1e-3))
    hist = ff.fit(x, y, batch_size=batch_size, epochs=epochs)
    print("final:", hist[-1])
    return hist


if __name__ == "__main__":
    main()
