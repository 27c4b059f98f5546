"""The native safetensors reader (``native/safetensors_reader.cc``) through
ctypes (port of ``flexflow_tpu/utils/native_safetensors.py``).

Zero-copy: each tensor is a numpy view straight into the file's ``mmap``
(bf16 is widened to float32, as the pure-Python reader does). The library is
built at first use (``native_build``); a failed build raises.
``utils/hf_weights.py`` reads checkpoints through it; its pure-Python
``SafetensorsFile`` is the plain version the tests hold it against.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterator, Tuple

import numpy as np

from flexflow_tpu_torch.utils import native_build

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "BF16": None,  # no numpy bf16: raw uint16 bits, widened to float32
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native_build.load("safetensors_reader.cc")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.stx_open.restype = vp
        lib.stx_open.argtypes = [ctypes.c_char_p]
        lib.stx_error.restype = ctypes.c_char_p
        lib.stx_error.argtypes = [vp]
        lib.stx_num_tensors.restype = i
        lib.stx_num_tensors.argtypes = [vp]
        lib.stx_name.restype = ctypes.c_char_p
        lib.stx_name.argtypes = [vp, i]
        lib.stx_dtype.restype = ctypes.c_char_p
        lib.stx_dtype.argtypes = [vp, i]
        lib.stx_ndim.restype = i
        lib.stx_ndim.argtypes = [vp, i]
        lib.stx_shape.argtypes = [vp, i, ctypes.POINTER(ctypes.c_int64)]
        lib.stx_data.restype = vp
        lib.stx_data.argtypes = [vp, i, ctypes.POINTER(ctypes.c_int64)]
        lib.stx_close.argtypes = [vp]
        _lib = lib
    return _lib


class NativeSafetensors:
    """Mapping-like zero-copy view over one ``.safetensors`` file. The
    arrays it returns point into the file's mapping: keep this object alive
    while they are in use."""

    def __init__(self, path: str):
        lib = _load()
        self._lib = lib
        self._h = lib.stx_open(path.encode())
        err = lib.stx_error(self._h)
        if err:
            lib.stx_close(self._h)
            self._h = None
            raise ValueError(f"safetensors open failed: {err.decode()} ({path})")
        self._index: Dict[str, int] = {
            lib.stx_name(self._h, i).decode(): i for i in range(lib.stx_num_tensors(self._h))}

    def keys(self):
        return self._index.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __getitem__(self, name: str) -> np.ndarray:
        i, lib = self._index[name], self._lib
        ndim = lib.stx_ndim(self._h, i)
        shape = (ctypes.c_int64 * max(ndim, 1))()
        lib.stx_shape(self._h, i, shape)
        nbytes = ctypes.c_int64()
        ptr = lib.stx_data(self._h, i, ctypes.byref(nbytes))
        dt = lib.stx_dtype(self._h, i).decode()
        if dt not in _DTYPES:
            raise ValueError(f"{name}: unsupported safetensors dtype {dt}")
        buf = (ctypes.c_char * nbytes.value).from_address(ptr)
        dims = tuple(shape[:ndim])
        if _DTYPES[dt] is None:
            raw = np.frombuffer(buf, dtype=np.uint16).reshape(dims)
            return (raw.astype(np.uint32) << 16).view(np.float32)
        return np.frombuffer(buf, dtype=_DTYPES[dt]).reshape(dims)

    def get(self, name: str) -> np.ndarray:
        return self[name]

    def items(self) -> Iterator[Tuple[str, np.ndarray]]:
        for k in self._index:
            yield k, self[k]

    def close(self):
        if self._h is not None:
            self._lib.stx_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self.close()
