"""Where the split-K tuning variants' time goes (``i8_group`` and
``i4_and_2dot`` of ``csrc/qmm_variants.cu``), on a GPU.

    python -m flexflow_tpu_torch.benchmarks.splitk_breakdown [--sweep] [--reps N]

At the tuning shape (x [8, 4096] bf16, a 4096 x 11008 weight, group 128,
``tune_quant_kernel.make_data``) and each column width of the tuning run,
times the kernel beside three builds of its source with one part switched
off (``FF_SPLITK_OFF`` in the source): ``memory`` (no dequant or product: the packed rows, x and the
combine only), ``compute`` (no packed-row copies: x, the dequant of what
the ring holds, the products and the combine) and ``no-combine`` (each
block writes its own partial sums as the output). The copies give wrong
outputs; only the kernel itself is held to its plain version (1% of the
output's magnitude). ``--sweep`` also times the kernel at every split of
the contraction (``qmm_variants.split_candidates``; ``split_plan`` picks
one of them). Times are
device time rotating past the L2, as the tuning run's; the card's name and
power limit come first. Without a GPU it exits with 2; without ``nvcc``
it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import math
import subprocess
import sys

import torch

from flexflow_tpu_torch.benchmarks import tune_quant_kernel as tq
from flexflow_tpu_torch.benchmarks.tune_int4_variants import COLS
from flexflow_tpu_torch.ops.kernels import _build
from flexflow_tpu_torch.ops.kernels import qmm_variants as qv
from flexflow_tpu_torch.quant.weight_only import quantize

# the FF_SPLITK_OFF bits (csrc/qmm_variants.cu) that switch each part off
PARTS = {"memory": 1, "compute": 2, "no-combine": 4}


def nvcc_args(src, part, lib) -> list:
    """nvcc's arguments for ``src`` built with ``part`` switched off (None:
    the kernel as it is) into ``lib``."""
    off = [] if part is None else [f"-DFF_SPLITK_OFF={PARTS[part]}"]
    return [*_build.NVCC_FLAGS, *off, "-shared", str(src), "-o", str(lib)]


def build(parts) -> dict:
    """One shared library per part (None: the source as it is), one nvcc
    each, started together; returns {part: ctypes handle}."""
    src = _build.CSRC_DIR / "qmm_variants.cu"
    out = _build.BUILD_ROOT / f"splitk-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for part in parts:
        lib = out / f"{part or 'kernel'}.so"
        procs[part] = (lib, subprocess.Popen(
            [_build._nvcc(), *nvcc_args(src, part, lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for part, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log}")
        handle = ctypes.CDLL(str(lib))
        for name in qv.SPLIT_K:
            fn = getattr(handle, f"ff_qmm_v_{name}")
            fn.argtypes = _build.SIGNATURES[f"ff_qmm_v_{name}"]
            fn.restype = ctypes.c_int
        libs[part] = handle
    return libs


def launch(lib, name: str, x, qa, cols: int, plan) -> torch.Tensor:
    """Variant ``name`` from ``lib`` on carrier ``qa`` at ``plan``'s split."""
    out = torch.empty((x.shape[0], qa.d_rest), dtype=x.dtype, device=x.device)
    tables = [qa.scale] + ([qa.offset] if name == "i4_and_2dot" else [])
    ws, tk = qv._workspace(plan, x.device)
    err = getattr(lib, f"ff_qmm_v_{name}")(
        x.data_ptr(), qa.q.data_ptr(), *[t.data_ptr() for t in tables], out.data_ptr(),
        0 if ws is None else ws.data_ptr(), 0 if tk is None else tk.data_ptr(),
        x.shape[0], x.shape[1], qa.q.shape[-1], qa.d_rest, qa.group_size, cols, plan.splits,
        0 if ws is None else ws.numel(), 0 if tk is None else tk.numel(),
        _build.stream_ptr(x.device))
    _build.check(err, name)
    return out


def run(reps: int = 20, sweep: bool = False, d: int = 4096, f: int = 11008, b: int = 8,
        group_size: int = 128) -> list:
    """Prints and returns one record a (variant, width, part or split)."""
    dev = torch.device("cuda")
    print(tq.card(dev), flush=True)
    libs = build([None, *PARTS])
    x, w = tq.make_data(d, f, b, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    recs = []
    for name in qv.SPLIT_K:
        bits = 4 if name == "i4_and_2dot" else 8
        qa = quantize(w, bits, group_size)
        rot = tq.rotation(qa, dev)
        want = qv.plain(name, x, qa).float()
        for cols in COLS:
            plan = qv.split_plan(name, b, d, f, group_size, cols, sms)
            got = launch(libs[None], name, x, qa, cols, plan).float()
            err = (got - want).abs().max().item()
            if not err <= 1e-2 * want.abs().max().item():
                raise RuntimeError(f"{name} cols={cols}: max|err| {err}")
            times = {}
            for part, lib in libs.items():
                times[part or "kernel"] = tq.op_time(
                    lambda c: launch(lib, name, x, c, cols, plan), rot, reps, dev) * 1e3
            recs.append(dict(variant=name, cols=cols, splits=plan.splits, ms=times))
            print(f"{name} cols={cols} split {plan.splits}: " + " | ".join(
                f"{k} {v:.4f} ms" for k, v in times.items()), flush=True)
            if not sweep:
                continue
            row = []
            for p in qv.split_candidates(name, b, d, f, group_size, cols):
                t = tq.op_time(lambda c: launch(libs[None], name, x, c, cols, p), rot, reps,
                               dev) * 1e3
                recs.append(dict(variant=name, cols=cols, splits=p.splits,
                                 blocks=math.prod(p.grid), ms={"kernel": t}))
                row.append(f"{p.splits}: {t:.4f}")
            print(f"{name} cols={cols} by split (ms): " + " | ".join(row), flush=True)
        del rot, qa
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20, help="timed calls per case")
    ap.add_argument("--sweep", action="store_true", help="also time every split")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("splitk_breakdown: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    run(args.reps, args.sweep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
