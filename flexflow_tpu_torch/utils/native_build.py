"""Build and load the repository's native C++ components (``native/*.cc``:
the scheduler core, the safetensors reader, the BPE core) for the port.

Each source is compiled on first use by its own ``g++ -O2 -std=c++17 -fPIC
-shared`` into ``flexflow_tpu_torch/_build/native/<hash>/`` (git-ignored),
keyed by the source's content and the flags, and loaded with ``ctypes``.
The port never writes into ``native/`` and never loads the shared objects
kept there. A failed build raises: no module falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parents[1]
NATIVE_DIR = PKG_DIR.parent / "native"
BUILD_DIR = PKG_DIR / "_build" / "native"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build(source: str) -> Path:
    """Compile ``native/<source>`` into a shared library (once per content
    and flags); returns its path."""
    src = NATIVE_DIR / source
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / h / f"lib{src.stem}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"lib{src.stem}.{os.getpid()}.so")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(src)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {source}: {e}") from e
    if r.returncode:
        raise RuntimeError(f"building {source} failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``native/<source>`` (built on first call)."""
    with _lock:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(str(build(source)))
        return _libs[source]
