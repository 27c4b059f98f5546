"""Build and load the port's CUDA kernels (``flexflow_tpu_torch/csrc/*.cu``).

Every source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` (``-gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler
-fPIC``), and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. No source includes PyTorch's headers, so a
build takes seconds. The library lands in ``flexflow_tpu_torch/_build/<hash>``
(git-ignored), keyed by the sources' content, and is built at first use: never
when a module is imported.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, never synchronises, and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of every entry point (all return cudaError_t as int)
SIGNATURES = {
    "ff_qmm_int8": [_P] * 5 + [_I] * 5 + [_L, _I, _I, _P],
    "ff_qmm_int4": [_P] * 6 + [_I] * 5 + [_L, _I, _I, _P],
    "ff_decode_attention": [_P] * 11 + [_I] * 7 + [_F, _I, _P],
    "ff_decode_attention_shard": [_P] * 11 + [_I] * 7 + [_F, _I, _I, _I, _P],
    "ff_merge_states": [_P, _P] + [_I] * 5 + [_P],
    "ff_flash_prefill": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "ff_qmm_v_i8_group": [_P] * 6 + [_I] * 7 + [_L, _I, _P],
    "ff_qmm_v_i4_and_2dot": [_P] * 7 + [_I] * 7 + [_L, _I, _P],
    **{f"ff_qmm_v_{v}": [_P] * 5 + [_I] * 6 + [_P]
       for v in ("i4_floor", "i4_3dot", "i4_and", "i4_and_bigdot")},
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build (None: cached)
build_log: str = ""  # nvcc's output (register / shared-memory use per kernel)


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link them
    into one library; returns its path. Reuses a library built from the same
    sources and flags."""
    global build_seconds, build_log
    srcs = _sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib_path = out_dir / "libff_kernels.so"
    if lib_path.exists():
        return lib_path
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in srcs:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode:
            failed.append(src.name)
    build_log = "\n".join(logs)
    (out_dir / "build.log").write_text(build_log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp = out_dir / f"libff_kernels.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise when a kernel launch reported a CUDA error."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device`` as a raw handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
