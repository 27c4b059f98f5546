#!/usr/bin/env python
"""Encoder-style Transformer via the DSL's MHA op (reference
examples/cpp/Transformer)."""

import numpy as np

from flexflow_tpu_torch.ffmodel import AdamOptimizer, FFModel


def build_transformer(ff, batch_size, seq=16, vocab=128, d=64, layers=2,
                      heads=4, classes=2):
    t = ff.create_tensor((batch_size, seq), dtype=np.int32)
    h = ff.embedding(t, vocab, d)
    for _ in range(layers):
        attn = ff.multihead_attention(h, h, h, embed_dim=d, num_heads=heads,
                                      causal=True)
        h = ff.layer_norm(ff.add(h, attn))
        mlp = ff.dense(ff.dense(h, 4 * d, activation="gelu"), d)
        h = ff.layer_norm(ff.add(h, mlp))
    h = ff.mean(h, dims=(1,))
    h = ff.dense(h, classes)
    return ff


def main(batch_size=16, epochs=5, samples=128, device=None):
    ff = FFModel(device=device)
    build_transformer(ff, batch_size)
    ff.compile(optimizer=AdamOptimizer(lr=1e-3))
    rng = np.random.RandomState(0)
    x = rng.randint(0, 128, size=(samples, 16)).astype(np.int32)
    y = (x.sum(-1) % 2).astype(np.int32)
    hist = ff.fit(x, y, batch_size=batch_size, epochs=epochs)
    print("final:", hist[-1])


if __name__ == "__main__":
    main()
