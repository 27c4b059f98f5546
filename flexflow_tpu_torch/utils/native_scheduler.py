"""The native scheduler core (``native/scheduler_core.cc``) through ctypes
(port of ``flexflow_tpu/utils/native_scheduler.py``).

The reference runs its continuous-batching bookkeeping in C++ on a CPU task
of its own; here the request manager applies every fetched batch of tokens
to its slots (append, EOS, stop ids, max-new and cache-budget retirement)
through ``process_horizon``, so the core is the one retirement rule of the
incremental server. ``process_horizon_plain`` is the same rule as a Python
loop: the plain version the tests hold the core against. The library is
built at first use (``native_build``); a failed build raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from flexflow_tpu_torch.utils import native_build

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native_build.load("scheduler_core.cc")
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.ff_process_horizon.restype = ctypes.c_int32
        lib.ff_process_horizon.argtypes = [
            i32p, ctypes.c_int32, ctypes.c_int32,  # tokens, n, b
            i32p, i32p, i32p, i32p, i32p, ctypes.c_int32,  # active .. margin
            i32p, ctypes.c_int32,  # eos
            i32p, i32p, ctypes.c_int32,  # stop sets
            i32p, i32p, i32p,  # outputs
        ]
        _lib = lib
    return _lib


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def process_horizon(
    tokens: np.ndarray,  # [n, B] int32
    active: np.ndarray,  # [B] (1 = live)
    out_counts: np.ndarray,  # [B] int32 tokens produced per slot (in/out)
    max_new: np.ndarray,  # [B]
    total_lens: np.ndarray,  # [B] int32 prompt + output lengths (in/out)
    seq_budget: np.ndarray,  # [B]
    horizon_margin: int,
    eos_ids: np.ndarray,  # [n_eos]
    stop_ids: np.ndarray,  # [B, max_stop]
    stop_counts: np.ndarray,  # [B]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Apply a horizon in the native core. Returns (out_tokens [B, n], the
    tokens each slot took, in order; out_taken [B]; out_finished [B]).
    ``out_counts`` and ``total_lens`` (int32, contiguous) are updated in
    place. A slot finishes at an EOS or stop id, at ``max_new`` tokens, or
    when ``total + horizon_margin > seq_budget``."""
    lib = _load()
    n, b = tokens.shape
    for a in (out_counts, total_lens):
        if a.dtype != np.int32 or not a.flags.c_contiguous:
            raise TypeError("out_counts and total_lens must be contiguous int32 (updated in place)")
    if any(np.shape(a) != (b,) for a in (active, out_counts, max_new, total_lens, seq_budget,
                                         stop_counts)) or np.shape(stop_ids)[0] != b:
        raise ValueError(f"every per-slot array must have {b} rows (tokens is {tokens.shape})")
    if np.any(np.asarray(stop_counts) > (stop_ids.shape[1] if stop_ids.ndim == 2 else 0)):
        raise ValueError("a stop count exceeds stop_ids' width")
    out_tokens = np.zeros((b, n), np.int32)
    out_taken = np.zeros(b, np.int32)
    out_finished = np.zeros(b, np.int32)
    max_stop = stop_ids.shape[1] if stop_ids.size else 0
    lib.ff_process_horizon(
        _p(_i32(tokens)), n, b, _p(_i32(active)), _p(out_counts), _p(_i32(max_new)),
        _p(total_lens), _p(_i32(seq_budget)), int(horizon_margin),
        _p(_i32(eos_ids)), len(eos_ids), _p(_i32(stop_ids)), _p(_i32(stop_counts)), max_stop,
        _p(out_tokens), _p(out_taken), _p(out_finished))
    return out_tokens, out_taken, out_finished


def process_horizon_plain(tokens, active, out_counts, max_new, total_lens, seq_budget,
                          horizon_margin: int, eos_ids, stop_ids, stop_counts):
    """The Python loop :func:`process_horizon` replaces: same arguments,
    same results, ``out_counts`` and ``total_lens`` updated in place."""
    n, b = tokens.shape
    out_tokens = np.zeros((b, n), np.int32)
    out_taken = np.zeros(b, np.int32)
    out_finished = np.zeros(b, np.int32)
    eos = {int(e) for e in eos_ids}
    for s in range(b):
        if not active[s]:
            continue
        stops = {int(t) for t in stop_ids[s, :stop_counts[s]]} if stop_ids.size else set()
        for i in range(n):
            tok = int(tokens[i, s])
            out_tokens[s, out_taken[s]] = tok
            out_taken[s] += 1
            out_counts[s] += 1
            total_lens[s] += 1
            if (tok in eos or tok in stops or out_counts[s] >= max_new[s]
                    or total_lens[s] + horizon_margin > seq_budget[s]):
                out_finished[s] = 1
                break
    return out_tokens, out_taken, out_finished
