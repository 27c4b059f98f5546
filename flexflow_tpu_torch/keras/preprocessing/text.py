"""Keras-compatible text preprocessing (port of ``flexflow_tpu/keras/preprocessing/text.py``)."""

from __future__ import annotations

import re
from collections import Counter


def text_to_word_sequence(text, filters='!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n',
                          lower=True, split=" "):
    if lower:
        text = text.lower()
    trans = str.maketrans({c: split for c in filters})
    return [w for w in text.translate(trans).split(split) if w]


class Tokenizer:
    """Word-level tokenizer with keras fit_on_texts/texts_to_sequences."""

    def __init__(self, num_words=None, oov_token=None, lower=True):
        self.num_words = num_words
        self.oov_token = oov_token
        self.lower = lower
        self.word_counts = Counter()
        self.word_index = {}

    def fit_on_texts(self, texts):
        for t in texts:
            self.word_counts.update(text_to_word_sequence(t, lower=self.lower))
        vocab = [w for w, _ in self.word_counts.most_common()]
        offset = 1
        self.word_index = {}
        if self.oov_token:
            self.word_index[self.oov_token] = 1
            offset = 2
        for i, w in enumerate(vocab):
            self.word_index[w] = i + offset

    def texts_to_sequences(self, texts):
        out = []
        cap = self.num_words
        for t in texts:
            seq = []
            for w in text_to_word_sequence(t, lower=self.lower):
                idx = self.word_index.get(w)
                if idx is None:
                    if self.oov_token:
                        seq.append(self.word_index[self.oov_token])
                    continue
                if cap and idx >= cap:
                    if self.oov_token:
                        seq.append(self.word_index[self.oov_token])
                    continue
                seq.append(idx)
            out.append(seq)
        return out
