"""Keras-compatible sequence preprocessing (port of
``flexflow_tpu/keras/preprocessing/sequence.py``)."""

from __future__ import annotations

import numpy as np


def pad_sequences(sequences, maxlen=None, dtype="int32", padding="pre",
                  truncating="pre", value=0.0):
    """Pad/truncate a list of token-id lists to a [N, maxlen] array."""
    lengths = [len(s) for s in sequences]
    maxlen = maxlen if maxlen is not None else max(lengths or [0])
    out = np.full((len(sequences), maxlen), value, dtype=dtype)
    for i, s in enumerate(sequences):
        if not len(s):
            continue
        s = list(s)
        if len(s) > maxlen:
            s = s[-maxlen:] if truncating == "pre" else s[:maxlen]
        if padding == "pre":
            out[i, -len(s):] = s
        else:
            out[i, : len(s)] = s
    return out
