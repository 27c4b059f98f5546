"""Checkpoint save and restore for parameters, optimizer states and LoRA
adapters (port of ``flexflow_tpu/utils/checkpoint.py``, the same format).

One ``.npz`` keyed by the tree path ("layers/wq", "m/layers/wq", ...) with
a ``__tree_meta__`` JSON entry describing the tree: dicts (sorted keys),
lists, tuples, None, optimizer NamedTuples (by class name) and quantized
leaves, whose carriers are stored under ``path/q``, ``path/scale`` and
``path/offset`` with their aux fields. A checkpoint written by either
package loads in the other.

bfloat16: the JAX package's leaves are ml_dtypes bfloat16, which ``np.savez``
stores as raw 2-byte voids (``|V2``). The port writes a bfloat16 tensor the
same way (its bits as ``|V2``) and reads every ``|V2`` array as bfloat16
bits; it needs no ml_dtypes. (JAX's ``load_checkpoint`` refuses ``|V2``
arrays, its own files included.) A quantized leaf's ``rest_pad`` is not in
the format; the port reads it off the carrier's width.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.quant.weight_only import QuantizedArray

_SEP = "/"
_META_KEY = "__tree_meta__"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
           "float64": torch.float64}


def _to_numpy(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.dtype("V2"))
    return x.numpy()


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _flatten(tree, prefix="") -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    out: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, QuantizedArray):
            meta[path] = {"kind": "quantized",
                          "aux": [node.bits, node.group_size, list(node.shape), node.batch_dims,
                                  node.contract_dims, _dtype_name(node.dtype)]}
            for name in ("q", "scale", "offset"):
                child = getattr(node, name)
                if child is not None:
                    out[f"{path}{_SEP}{name}"] = _to_numpy(child)
            return
        if isinstance(node, dict):
            meta[path] = {"kind": "dict", "keys": sorted(node.keys())}
            for k in sorted(node.keys()):
                walk(node[k], f"{path}{_SEP}{k}" if path else k)
            return
        if hasattr(node, "_fields"):  # a NamedTuple (optimizer states), before tuple
            meta[path] = {"kind": "namedtuple", "cls": type(node).__name__,
                          "fields": list(node._fields)}
            for f in node._fields:
                walk(getattr(node, f), f"{path}{_SEP}{f}" if path else f)
            return
        if isinstance(node, (list, tuple)):
            meta[path] = {"kind": "tuple" if isinstance(node, tuple) else "list", "n": len(node)}
            for i, v in enumerate(node):
                walk(v, f"{path}{_SEP}{i}" if path else str(i))
            return
        if node is None:
            meta[path] = {"kind": "none"}
            return
        out[path] = _to_numpy(node)
        meta[path] = {"kind": "array"}

    walk(tree, prefix)
    return out, meta


def save_checkpoint(path, tree: Any) -> None:
    """Write ``tree`` to ``path`` (a file name, or a binary file object)."""
    arrays, meta = _flatten(tree)
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    if isinstance(path, (str, os.PathLike)):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_checkpoint(path, *, namedtuple_registry=None, device="cpu") -> Any:
    """Rebuild the tree from ``path`` (a file name, or a binary file object)
    with its tensors on ``device``; optimizer NamedTuples resolve by class
    name through the registry (default: the port's SGDState and AdamState)."""
    from flexflow_tpu_torch.training.optimizers import AdamState, SGDState

    registry = {"SGDState": SGDState, "AdamState": AdamState, **(namedtuple_registry or {})}
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays[_META_KEY].tolist()).decode())

    def build(path):
        m = meta[path]
        kind = m["kind"]
        if kind == "array":
            return _from_numpy(arrays[path], device)
        if kind == "none":
            return None
        if kind == "quantized":
            bits, group_size, shape, batch_dims, contract_dims, dtype = m["aux"][:6]
            q, scale, offset = (
                _from_numpy(arrays[k], device) if k in arrays else None
                for k in (f"{path}{_SEP}{n}" for n in ("q", "scale", "offset")))
            shape = tuple(shape)
            d_rest = math.prod(shape[batch_dims + contract_dims:])
            return QuantizedArray(q, scale, offset, bits, group_size, shape, batch_dims,
                                  contract_dims, _DTYPES[dtype], q.shape[-1] - d_rest)
        if kind == "dict":
            return {k: build(f"{path}{_SEP}{k}" if path else k) for k in m["keys"]}
        if kind in ("list", "tuple"):
            items = [build(f"{path}{_SEP}{i}" if path else str(i)) for i in range(m["n"])]
            return tuple(items) if kind == "tuple" else items
        if kind == "namedtuple":
            return registry[m["cls"]](**{f: build(f"{path}{_SEP}{f}" if path else f)
                                         for f in m["fields"]})
        raise ValueError(f"unknown checkpoint node kind {kind!r}")

    return build("")


def save_lora_adapter(path: str, lora, adapter: int, *, spec=None, shard=None) -> None:
    """Export one adapter slot of JAX-layout stacks ({module: {"a": [L, N,
    D_in, r], "b": [L, N, r, D_out]}}; an engine's routed adapters through
    ``peft/lora.unroute_lora``) as a checkpoint of [L, D_in, r] / [L, r,
    D_out] leaves (the reference's save_updated_weights). ``shard`` (with
    the model's ``spec``): ``lora`` is a mesh rank's cut; every rank calls
    this, the stacks are gathered over each cut's group and rank 0 writes
    them."""
    if shard is not None:
        from flexflow_tpu_torch.parallel.sharding import gather_lora

        lora = gather_lora(spec, lora, shard)
        if shard.mesh.rank != 0:
            return
    save_checkpoint(path, {mod: {k: v[:, adapter] for k, v in ab.items()}
                           for mod, ab in lora.items()})
