"""Design variants of the INT8/INT4 dequant matmul, timed against the port's
production kernels (counterpart of ``benchmarks/tune_int4_variants.py``).

    python -m flexflow_tpu_torch.benchmarks.tune_int4_variants [--padded] [--device cpu]
        [--reps N] [pattern ...]

At D=4096, F=11008 (11264 with ``--padded``; the quantizer pads the carrier
to 11264 either way), B=8, group 128, seed 0, each variant of
``ops/kernels/qmm_variants.py`` runs at three column tile widths
(``COLS``; an H100 has 132 SMs, and 11008 columns make 688, 344 and 172
tiles of them), followed by the production kernels ``i8-prod``
(``qmm_int8``) and ``i4-prod`` (``qmm_int4``). Each case prints its time in
us, the packed weight bytes over that time, the time those bytes take at
3.35 TB/s, and ``relerr`` against ``x @ dequantize(qa)`` (see
``tune_quant_kernel``); on a GPU, ``i8_group`` and ``i4_and_2dot`` then print
the split of the contraction they launched with (``qmm_variants.split_plan``:
blocks along it, groups or group pairs a block, column tiles a block).
Cases whose name contains none of the patterns are skipped. A failed case
prints ``FAILED``; the run then exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import torch

from flexflow_tpu_torch.benchmarks.tune_quant_kernel import (
    card, make_data, reference, rotation, run_case)
from flexflow_tpu_torch.device import resolve_device
from flexflow_tpu_torch.ops.kernels import qmm_variants as qv
from flexflow_tpu_torch.ops.kernels import quant_matmul as qm
from flexflow_tpu_torch.quant.weight_only import quantize

COLS = (16, 32, 64)


def run(d: int = 4096, f: int = 11008, b: int = 8, group_size: int = 128, *, device=None,
        reps: int = 20, patterns=()) -> tuple:
    """Every case whose name contains one of ``patterns`` (all without any).
    Returns their records, each with its ``variant`` (the wrapper's name, or
    ``qmm_int8`` / ``qmm_int4``), ``cols`` (None for the production kernels)
    and ``bits``, and the run's data: ``x``, the carriers by bit width
    (``qa``) and the L2 rotations the cases were timed on (``rot``, by bit
    width; its first entry is the carrier itself). A split-K variant's record
    on a GPU also holds its ``split`` (``qmm_variants.SplitPlan``; else None)."""
    dev = resolve_device(device)
    x, w = make_data(d, f, b, dev)
    qa = {8: quantize(w, 8, group_size), 4: quantize(w, 4, group_size)}
    del w
    ref = {bits: reference(x, c) for bits, c in qa.items()}
    cases = [(f"{name.replace('_', '-')} cols={c}", name, c,
              8 if name == "i8_group" else 4) for c in COLS for name in qv.VARIANTS]
    cases += [("i8-prod", "qmm_int8", None, 8), ("i4-prod", "qmm_int4", None, 4)]
    if patterns:
        cases = [cs for cs in cases if any(p in cs[0] for p in patterns)]
    rot = {}
    recs = []
    for label, name, c, bits in cases:
        if bits not in rot:
            rot[bits] = rotation(qa[bits], dev)
        if c is None:
            def fn(carrier):
                return qm.quant_matmul(x, carrier)
        else:
            def fn(carrier, name=name, c=c):
                return qv.variant(name, x, carrier, c)
        rec = run_case(label, fn, rot[bits], qa[bits].q.numel(), ref[bits], reps, dev)
        split = qv.plan_of(name, x, qa[bits], c)
        if split is not None:
            print(f"{label}: split {split.splits} blocks along D, {split.units_per_block} of "
                  f"{split.units} units a block, {split.tiles_per_block} column tiles a block",
                  flush=True)
        rec.update(variant=name, cols=c, bits=bits, split=split)
        recs.append(rec)
    return recs, dict(x=x, qa=qa, rot=rot)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("patterns", nargs="*", help="run only cases whose name contains one")
    ap.add_argument("--padded", action="store_true", help="F = 11264 instead of 11008")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=20, help="timed calls per case")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {card(dev)}", flush=True)
    recs, _ = run(f=11264 if args.padded else 11008, device=dev, reps=args.reps,
                  patterns=args.patterns)
    return 0 if recs and all(r["ok"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
