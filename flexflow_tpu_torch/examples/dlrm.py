#!/usr/bin/env python
"""DLRM: embeddings + bottom/top MLPs + pairwise feature interaction
(reference examples/cpp/DLRM)."""

import numpy as np

from flexflow_tpu_torch.ffmodel import AdamOptimizer, FFModel


def build_dlrm(ff, batch_size, *, num_sparse=4, vocab=100, emb_dim=16,
               dense_dim=13):
    dense_in = ff.create_tensor((batch_size, dense_dim))
    sparse_ins = [
        ff.create_tensor((batch_size, 1), dtype=np.int32)
        for _ in range(num_sparse)
    ]
    # bottom MLP over dense features
    t = ff.dense(dense_in, 64, activation="relu")
    t = ff.dense(t, emb_dim, activation="relu")
    # sparse embeddings
    embs = [ff.embedding(s, vocab, emb_dim, aggr="sum") for s in sparse_ins]
    # feature interaction: concat + pairwise dot via batch_matmul
    feats = ff.concat([t] + embs, axis=1)  # [B, (1+S)*E]
    n_f = 1 + num_sparse
    fmat = ff.reshape(feats, (batch_size, n_f, emb_dim))
    inter = ff.batch_matmul(fmat, ff.transpose(fmat, (0, 2, 1)))  # [B, F, F]
    inter = ff.flat(inter)
    top = ff.concat([feats, inter], axis=1)
    # top MLP
    t = ff.dense(top, 64, activation="relu")
    t = ff.dense(t, 32, activation="relu")
    t = ff.dense(t, 2)
    return ff


def main(batch_size=32, epochs=3, samples=256, device=None):
    ff = FFModel(device=device)
    build_dlrm(ff, batch_size)
    ff.compile(optimizer=AdamOptimizer(lr=1e-2))
    rng = np.random.RandomState(0)
    dense = rng.randn(samples, 13).astype(np.float32)
    sparse = [rng.randint(0, 100, size=(samples, 1)).astype(np.int32)
              for _ in range(4)]
    y = ((dense.sum(-1) + sum(s[:, 0] % 7 for s in sparse)) > 8).astype(np.int32)
    hist = ff.fit([dense] + sparse, y, batch_size=batch_size, epochs=epochs)
    print("final:", hist[-1])


if __name__ == "__main__":
    main()
