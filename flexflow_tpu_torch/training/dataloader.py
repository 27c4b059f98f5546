"""SingleDataLoader — batched, shuffled data feed (port of
``flexflow_tpu/training/dataloader.py``).

The full arrays stay in host memory and every batch is a list of numpy
arrays, shuffled by ``np.random.RandomState(seed + epoch)`` as in JAX, so
both packages give the same batches. The caller moves a batch to its
device (the Trainer does). With a ``parallel/mesh.Mesh`` every batch is
the data rank's contiguous block of the global batch's rows (JAX's
``P("data")`` shard, the one this rank addresses) as :class:`RankRows`,
which a mesh Trainer takes as it is.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np

from flexflow_tpu_torch.parallel.sharding import data_rows


class RankRows(np.ndarray):
    """A data rank's rows of a global batch (``SingleDataLoader(mesh=)``)."""


class SingleDataLoader:
    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, mesh=None, drop_last: bool = True):
        self.mesh = mesh
        self.arrays = [np.asarray(a) for a in arrays]
        n = self.arrays[0].shape[0]
        if any(a.shape[0] != n for a in self.arrays):
            raise ValueError("every array needs the same leading (sample) length")
        self.num_samples = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    @property
    def num_batches(self) -> int:
        if self.drop_last:
            return self.num_samples // self.batch_size
        return -(-self.num_samples // self.batch_size)

    def epoch(self) -> Iterator[List[np.ndarray]]:
        """One pass over the data."""
        idx = np.arange(self.num_samples)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        stop = self.num_samples - self.batch_size + 1 if self.drop_last else self.num_samples
        for i in range(0, stop, self.batch_size):
            sel = idx[i:i + self.batch_size]
            batch = [a[sel] for a in self.arrays]
            if self.mesh is not None:
                batch = [data_rows(b, self.mesh).view(RankRows) for b in batch]
            yield batch

    def __iter__(self):
        return self.epoch()
