"""HuggingFace checkpoint loading (port of ``flexflow_tpu/utils/hf_weights.py``).

Safetensors shards are read through the native reader
(``utils/native_safetensors.py``, ``native/safetensors_reader.cc``: zero-copy
views into an ``mmap`` of each file), as the JAX package reads them.
``SafetensorsFile`` is the pure-Python reader of the same format (an 8-byte
little-endian header length, a JSON header naming each tensor's dtype, shape
and byte range, ``numpy.frombuffer`` over an ``mmap``): the plain version
the native reader is tested against. ``save_safetensors`` writes the format.
No ``safetensors`` package is needed. (``pytorch_model*.bin`` shards are
not read yet.)
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from typing import Dict, Optional

import numpy as np
import torch

from flexflow_tpu_torch.models import params as params_lib
from flexflow_tpu_torch.specs import ModelSpec, from_hf_config_file
from flexflow_tpu_torch.utils.native_safetensors import NativeSafetensors

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


class SafetensorsFile:
    """Read-only view of one ``.safetensors`` file."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        header.pop("__metadata__", None)
        self._header = header
        self._base = 8 + n

    def keys(self):
        return self._header.keys()

    def get(self, name: str) -> np.ndarray:
        """The tensor as float32 (bf16) or its own numpy dtype."""
        info = self._header[name]
        dt = info["dtype"]
        if dt not in _ST_DTYPES:
            raise ValueError(f"{name}: unsupported safetensors dtype {dt}")
        begin, end = info["data_offsets"]
        np_dt = np.dtype(_ST_DTYPES[dt])
        arr = np.frombuffer(self._mm, dtype=np_dt, count=(end - begin) // np_dt.itemsize,
                            offset=self._base + begin).reshape(info["shape"])
        if dt == "BF16":  # widen bf16 bits to float32 exactly
            return (arr.astype(np.uint32) << 16).view(np.float32)
        return arr

    def close(self):
        self._mm.close()


def save_safetensors(tensors: Dict[str, np.ndarray], path: str) -> None:
    """Write float32 arrays as one ``.safetensors`` file: the 8-byte header
    length, the JSON header (space-padded to a multiple of 8 bytes) and the
    raw little-endian bytes, in name order."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        blob = np.ascontiguousarray(tensors[name], dtype="<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(np.shape(tensors[name])),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


class LazyStateDict:
    """Mapping-like view over a model dir's safetensors shards (native
    reader); tensors are read on access."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        self._index: Dict[str, NativeSafetensors] = {}
        st_files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
        if not st_files:
            raise FileNotFoundError(f"No .safetensors weights in {model_dir}")
        for path in st_files:
            sf = NativeSafetensors(path)
            for name in sf.keys():
                self._index[name] = sf

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def keys(self):
        return self._index.keys()

    def __getitem__(self, name: str) -> np.ndarray:
        return self._index[name].get(name)


def load_spec(model_dir: str) -> ModelSpec:
    return from_hf_config_file(os.path.join(model_dir, "config.json"))


def load_params(
    model_dir: str,
    spec: Optional[ModelSpec] = None,
    *,
    dtype=torch.bfloat16,
    quantize_bits: Optional[int] = None,
    quantize_group_size: int = 128,
    device="cpu",
    host_layers: bool = False,
    mesh=None,
):
    """Load a local HF model dir into the decoder params on ``device``, with
    optional weight-only quantize-on-load (4 or 8 bits). Layers are read,
    converted and (with ``quantize_bits``) quantized one at a time, so a
    quantized load never holds the full-precision tree on the device; the
    carriers are byte for byte those of ``quantize_params`` on the whole
    converted tree. ``host_layers``: the layer stack goes to (pinned) host
    memory for CPU offload (``build_params``). ``mesh``: this rank's cut
    (``parallel/sharding``), each layer's tensors read from the memory-mapped
    shards and cut before the next layer is read, so no rank holds more of
    the whole model than one layer (and one top-level tensor)."""
    spec = spec or load_spec(model_dir)
    params = params_lib.convert_hf_state_dict(
        spec, LazyStateDict(model_dir), dtype, device, bits=quantize_bits,
        group_size=quantize_group_size, host_layers=host_layers, mesh=mesh)
    return spec, params
