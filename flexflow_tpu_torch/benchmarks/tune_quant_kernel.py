"""Timing harness for the port's fused dequant matmul (counterpart of
``benchmarks/tune_quant_kernel.py``).

    python -m flexflow_tpu_torch.benchmarks.tune_quant_kernel [--device cpu] [--reps N]

Five cases at LLaMA-2-7B's MLP shape (x [8, 4096] bf16 against a 4096 x 11008
weight, group 128, seeded random data): the bf16 product (``torch.matmul``, a
library reference that is timed and never part of the port), the port's
``qmm_int8`` / ``qmm_int4`` kernels ("prod"), and ``dequantize`` then
``torch.matmul`` ("dequant"). Each prints its time, the packed weight bytes
over that time, the time those bytes take at ``PEAK``, and its error against
``x @ dequantize(qa)`` in f32. A case that raises, gives a non-finite value or
misses by more than ``RELERR_LIMIT`` prints ``FAILED``, and the run exits
non-zero.

Timing: on a GPU, CUDA events around ``reps`` calls after a warm-up, with the
weight operand rotating through enough copies that the stream exceeds three
times the 50 MiB L2 (every carrier here fits in L2, and a resident one would
be read at the L2's rate). On the CPU the host clock times the plain versions;
those times say nothing about a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from flexflow_tpu_torch.device import resolve_device
from flexflow_tpu_torch.ops.kernels import quant_matmul as qm
from flexflow_tpu_torch.quant.weight_only import QuantizedArray, dequantize, quantize

PEAK = 3.35e12  # bytes/s: H100 SXM HBM3
L2_BYTES = 50 * 2**20
SLEEP_CYCLES_PER_S = 2e9  # cycles of torch.cuda._sleep per second at or above the H100's clock
RELERR_LIMIT = 1e-2  # of max |ref|: one bf16 rounding of w and of the output, with room


def card(device: torch.device) -> str:
    """The device's name: on a GPU, nvidia-smi's name and power limit (an
    nvidia-smi failure raises, since no GPU time stands without them)."""
    if device.type != "cuda":
        return "cpu (host clock; not a GPU time)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[device.index or 0]


def op_time(fn, operands: list, reps: int, device: torch.device, warmup: int = 2) -> float:
    """Mean seconds of ``fn(operand)`` over ``reps`` calls after ``warmup``
    more, cycling through ``operands`` (CUDA events on a GPU, the host clock
    on the CPU)."""
    for i in range(warmup):
        fn(operands[i % len(operands)])
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(reps):
            fn(operands[i % len(operands)])
        return (time.perf_counter() - t0) / reps
    # device time, not the host's launch rate: the device sleeps while the
    # host queues every timed call, so the calls run back to back (retried
    # with a longer sleep if the device woke before the queue was full)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn(operands[0])
    per_call = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    for attempt in range(4):
        sleep_s = 2.0 ** attempt * (2 * reps * per_call + 1e-3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
        start.record()
        for i in range(reps):
            fn(operands[i % len(operands)])
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize(device)
        if queued_in_time:
            break
    return start.elapsed_time(end) / reps / 1e3


def n_copies(nbytes: int, device: torch.device) -> int:
    """Copies of an operand whose rotation streams past 3x the L2 (1 on the CPU)."""
    return max(2, math.ceil(3 * L2_BYTES / nbytes)) if device.type == "cuda" else 1


def carrier_bytes(qa: QuantizedArray) -> int:
    return sum(t.numel() * t.element_size() for t in (qa.q, qa.scale, qa.offset) if t is not None)


def rotation(qa: QuantizedArray, device: torch.device) -> list:
    """``qa`` and clones of it, enough to stream past the L2."""
    n = n_copies(carrier_bytes(qa), device)
    return [qa] + [dataclasses.replace(
        qa, q=qa.q.clone(), scale=qa.scale.clone(),
        offset=None if qa.offset is None else qa.offset.clone()) for _ in range(n - 1)]


def make_data(d: int, f: int, b: int, device: torch.device):
    """x [b, d] bf16 and w [d, f] f32 (0.02 x standard normal) from numpy's
    RandomState(0), as the JAX harness draws them."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(b, d), dtype=torch.float32).to(torch.bfloat16)
    w = torch.tensor(rng.randn(d, f) * 0.02, dtype=torch.float32)
    return x.to(device), w.to(device)


def reference(x: torch.Tensor, qa: QuantizedArray) -> torch.Tensor:
    """x @ dequantize(qa) in f32 (the weight rounded once to bf16)."""
    return x.float() @ dequantize(qa).float()


def run_case(name: str, fn, operands: list, nbytes: int, ref: torch.Tensor, reps: int,
             device: torch.device) -> dict:
    """Check ``fn(operands[0])`` against ``ref``, time it and print one line;
    returns the case's record (``ok`` False if it failed)."""
    rec = dict(name=name, ok=False, nbytes=nbytes)
    try:
        got = fn(operands[0])[..., : ref.shape[-1]].float()
        finite = bool(torch.isfinite(got).all())
        rel = (got - ref).abs().max().item() / (ref.abs().max().item() + 1e-9)
        t = op_time(fn, operands, reps, device)
    except Exception as e:  # a case boundary: report it and go on to the next case
        rec["error"] = f"{type(e).__name__}: {str(e)[:120]}"
        traceback.print_exc()
        print(f"{name}: FAILED {rec['error']}", flush=True)
        return rec
    rec.update(ok=finite and rel <= RELERR_LIMIT, seconds=t, gb_s=nbytes / t / 1e9,
               sol_seconds=nbytes / PEAK, relerr=rel)
    line = (f"{name}: {t * 1e6:.1f} us ({nbytes / t / 1e9:.0f} GB/s packed, "
            f"SoL {nbytes / PEAK * 1e6:.1f} us) relerr={rel:.2e}")
    print(line if rec["ok"] else f"{name}: FAILED ({'non-finite, ' if not finite else ''}"
          f"relerr {rel:.2e} > {RELERR_LIMIT}) {line}", flush=True)
    return rec


def run(d: int = 4096, f: int = 11008, b: int = 8, group_size: int = 128, *, device=None,
        reps: int = 20) -> list:
    """The five cases; returns their records."""
    dev = resolve_device(device)
    x, w = make_data(d, f, b, dev)
    wb = w.to(torch.bfloat16)
    qa8 = quantize(w, 8, group_size)
    qa4 = quantize(w, 4, group_size)
    del w
    ref_b = x.float() @ wb.float()
    ref8, ref4 = reference(x, qa8), reference(x, qa4)
    r8, r4 = rotation(qa8, dev), rotation(qa4, dev)
    wbs = [wb] + [wb.clone() for _ in range(n_copies(wb.numel() * 2, dev) - 1)]
    cases = [
        ("bf16 GEMV", lambda wc: torch.matmul(x, wc), wbs, wb.numel() * 2, ref_b),
        ("int8 prod", lambda qa: qm.quant_matmul(x, qa), r8, qa8.q.numel(), ref8),
        ("int4 prod", lambda qa: qm.quant_matmul(x, qa), r4, qa4.q.numel(), ref4),
        ("int8 dequant", lambda qa: torch.matmul(x, dequantize(qa)), r8, qa8.q.numel(), ref8),
        ("int4 dequant", lambda qa: torch.matmul(x, dequantize(qa)), r4, qa4.q.numel(), ref4),
    ]
    return [run_case(name, fn, ops, nb, ref, reps, dev) for name, fn, ops, nb, ref in cases]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=20, help="timed calls per case")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {card(dev)}", flush=True)
    recs = run(device=dev, reps=args.reps)
    return 0 if all(r["ok"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
