"""Byte-level BPE tokenizer over the native C++ merge core
(``native/bpe_core.cc``; port of ``flexflow_tpu/utils/native_tokenizer.py``).

The reference's standalone GPT-2 / OPT tokenizer (vocab + merges files).
The Python side does the GPT-2 pre-tokenization and the byte <-> unicode
mapping; the C++ core runs the merge loop and the vocab lookups, with a
word cache. The library is built at first use (``native_build``); a failed
build raises.
"""

from __future__ import annotations

import ctypes
import json
import re
from typing import Dict, List

from flexflow_tpu_torch.utils import native_build

# GPT-2 pre-tokenization, approximated for the stdlib ``re`` module
# (letters as [^\W\d_], digits as \d)
_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE,
)

_lib = None


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native_build.load("bpe_core.cc")
        vp, cp, i32 = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32
        lib.bpe_create.restype = vp
        lib.bpe_free.argtypes = [vp]
        lib.bpe_add_token.argtypes = [vp, cp, i32]
        lib.bpe_set_unk.argtypes = [vp, i32]
        lib.bpe_add_merge.argtypes = [vp, cp, cp, i32]
        lib.bpe_encode_word.restype = i32
        lib.bpe_encode_word.argtypes = [vp, cp, ctypes.POINTER(i32), i32]
        lib.bpe_id_to_token.restype = cp
        lib.bpe_id_to_token.argtypes = [vp, i32]
        _lib = lib
    return _lib


class NativeBPETokenizer:
    """GPT-2-style byte-level BPE from vocab.json + merges.txt."""

    def __init__(self, vocab: Dict[str, int], merges: List[str]):
        lib = _load()
        self._lib = lib
        self._h = lib.bpe_create()
        self._byte_enc = _bytes_to_unicode()
        self._byte_dec = {v: k for k, v in self._byte_enc.items()}
        for tok, idx in vocab.items():
            lib.bpe_add_token(self._h, tok.encode(), idx)
        lib.bpe_set_unk(self._h, vocab.get("<unk>", 0))
        for rank, line in enumerate(merges):
            parts = line.strip().split(" ")
            if len(parts) == 2:
                lib.bpe_add_merge(self._h, parts[0].encode(), parts[1].encode(), rank)
        self._buf = (ctypes.c_int32 * 4096)()

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "NativeBPETokenizer":
        with open(vocab_path) as f:
            vocab = json.load(f)
        with open(merges_path) as f:
            merges = f.read().splitlines()
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        return cls(vocab, merges)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _PAT.findall(text):
            mapped = "".join(self._byte_enc[b] for b in word.encode("utf-8"))
            n = self._lib.bpe_encode_word(self._h, mapped.encode(), self._buf, len(self._buf))
            if n < 0:
                raise ValueError("word too long for the BPE buffer")
            ids.extend(self._buf[:n])
        return ids

    def decode(self, ids: List[int]) -> str:
        text = "".join(self._lib.bpe_id_to_token(self._h, int(i)).decode() for i in ids)
        data = bytes(self._byte_dec[c] for c in text if c in self._byte_dec)
        return data.decode("utf-8", errors="replace")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bpe_free(self._h)
            self._h = None
