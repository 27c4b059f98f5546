"""Parameter dicts: random init, HuggingFace import, and carry-over from the
JAX package (port of ``flexflow_tpu/models/params.py``, LLaMA converter only).

Layout matches the JAX package: torch ``nn.Linear.weight`` [out, in] becomes
[in, ...out] (contraction on the leading axis), and every per-layer leaf is
stacked on a leading [num_layers, ...] axis.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from flexflow_tpu_torch.quant.weight_only import QuantizedArray
from flexflow_tpu_torch.specs import ModelSpec

Params = Dict[str, Any]


def init_params(spec: ModelSpec, generator: Union[int, torch.Generator] = 0,
                dtype=torch.float32, device="cpu") -> Params:
    """Random-initialized parameters (Glorot normal for matmuls, ones for
    norm scales), drawn in order from one ``torch.Generator``."""
    device = torch.device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)

    def glorot(shape, fan_in, fan_out):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * float(np.sqrt(2.0 / (fan_in + fan_out)))).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    d, hh, kh, dh, f, ll = (spec.hidden_size, spec.num_heads, spec.num_kv_heads,
                            spec.head_dim, spec.intermediate_size, spec.num_layers)
    if spec.moe is not None:
        raise NotImplementedError("MoE models are not in the port yet")
    layers: Params = {
        "ln1_scale": ones((ll, d)),
        "ln2_scale": ones((ll, d)),
        "wq": glorot((ll, d, hh, dh), d, hh * dh),
        "wk": glorot((ll, d, kh, dh), d, kh * dh),
        "wv": glorot((ll, d, kh, dh), d, kh * dh),
        "wo": glorot((ll, hh, dh, d), hh * dh, d),
    }
    if spec.norm == "layernorm" and spec.norm_bias:
        layers["ln1_bias"] = zeros((ll, d))
        layers["ln2_bias"] = zeros((ll, d))
    if spec.qkv_bias:
        layers["bq"] = zeros((ll, hh, dh))
        layers["bk"] = zeros((ll, kh, dh))
        layers["bv"] = zeros((ll, kh, dh))
    if spec.attn_out_bias:
        layers["bo"] = zeros((ll, d))
    if spec.act == "silu_gate":
        layers["wg"] = glorot((ll, d, f), d, f)
    layers["wu"] = glorot((ll, d, f), d, f)
    layers["wd"] = glorot((ll, f, d), f, d)
    if spec.mlp_bias:
        layers["bu"] = zeros((ll, f))
        layers["bd"] = zeros((ll, d))

    params: Params = {
        "embed_tokens": glorot((spec.vocab_size, d), spec.vocab_size, d),
        "layers": layers,
        "final_norm_scale": ones((d,)),
    }
    if spec.norm == "layernorm" and spec.norm_bias:
        params["final_norm_bias"] = zeros((d,))
    if spec.pos == "learned":
        params["embed_pos"] = glorot(
            (spec.max_position_embeddings + spec.learned_pos_offset, d),
            spec.max_position_embeddings, d)
    if not spec.tie_word_embeddings:
        params["lm_head"] = glorot((d, spec.vocab_size), d, spec.vocab_size)
    return params


# ---------------------------------------------------------------------------
# HF state-dict import
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


def _lin(w: np.ndarray) -> np.ndarray:
    """torch Linear [out, in] -> ours [in, out]."""
    return np.ascontiguousarray(w.T)


def _heads(w: np.ndarray, n: int, dh: int) -> np.ndarray:
    """torch proj weight [n*dh, in] -> ours [in, n, dh]."""
    return np.ascontiguousarray(w.reshape(n, dh, -1).transpose(2, 0, 1))


def _convert_llama(spec: ModelSpec, sd: Mapping[str, Any]) -> Params:
    d, hh, kh, dh = spec.hidden_size, spec.num_heads, spec.num_kv_heads, spec.head_dim

    def get(name):
        return _np(sd[name])

    layers = []
    for i in range(spec.num_layers):
        p = f"model.layers.{i}."
        layer = {
            "ln1_scale": get(p + "input_layernorm.weight"),
            "ln2_scale": get(p + "post_attention_layernorm.weight"),
            "wq": _heads(get(p + "self_attn.q_proj.weight"), hh, dh),
            "wk": _heads(get(p + "self_attn.k_proj.weight"), kh, dh),
            "wv": _heads(get(p + "self_attn.v_proj.weight"), kh, dh),
            "wo": get(p + "self_attn.o_proj.weight").T.reshape(hh, dh, d),
            "wg": _lin(get(p + "mlp.gate_proj.weight")),
            "wu": _lin(get(p + "mlp.up_proj.weight")),
            "wd": _lin(get(p + "mlp.down_proj.weight")),
        }
        if spec.qkv_bias:
            layer["bq"] = get(p + "self_attn.q_proj.bias").reshape(hh, dh)
            layer["bk"] = get(p + "self_attn.k_proj.bias").reshape(kh, dh)
            layer["bv"] = get(p + "self_attn.v_proj.bias").reshape(kh, dh)
        layers.append(layer)
    params: Params = {
        "embed_tokens": get("model.embed_tokens.weight"),
        "layers": {k: np.stack([l[k] for l in layers]) for k in layers[0]},
        "final_norm_scale": get("model.norm.weight"),
    }
    if not spec.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = _lin(get("lm_head.weight"))
    return params


_CONVERTERS = {"LlamaForCausalLM": _convert_llama}


def convert_hf_state_dict(spec: ModelSpec, sd: Mapping[str, Any],
                          dtype=torch.float32, device="cpu") -> Params:
    """HuggingFace state dict -> the decoder's parameter dict (LLaMA family;
    the other architectures' converters are not ported yet)."""
    try:
        conv = _CONVERTERS[spec.arch]
    except KeyError:
        raise NotImplementedError(f"no converter for {spec.arch} in the port yet") from None
    return params_from_numpy(conv(spec, sd), device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# carry-over from the JAX package (numpy in, no JAX import)
# ---------------------------------------------------------------------------

_QFIELDS = ("q", "scale", "offset", "bits", "group_size", "shape", "batch_dims",
            "contract_dims", "rest_pad")


def _is_quantized(leaf) -> bool:
    if isinstance(leaf, Mapping):
        return "q" in leaf and "scale" in leaf and "bits" in leaf
    return all(hasattr(leaf, f) for f in ("q", "scale", "bits", "group_size"))


def params_from_numpy(tree, device="cpu", dtype=torch.float32):
    """Turn a parameter tree of numpy arrays (e.g. the JAX package's params
    after ``np.asarray`` on each leaf) into the port's tensors on ``device``.

    Float leaves (JAX's bfloat16 included) are cast to ``dtype``. Quantized
    leaves, given as objects or dicts with ``q/scale/offset/bits/group_size/
    shape/batch_dims/contract_dims/rest_pad``, keep their carriers byte for
    byte and get ``dtype`` as their compute dtype.
    """
    device = torch.device(device)
    if _is_quantized(tree):
        get = (lambda f: tree.get(f)) if isinstance(tree, Mapping) else (
            lambda f: getattr(tree, f, None))
        offset = get("offset")
        return QuantizedArray(
            q=torch.tensor(np.asarray(get("q")), device=device),
            scale=torch.tensor(np.asarray(get("scale"), np.float32), device=device),
            offset=None if offset is None else torch.tensor(
                np.asarray(offset, np.float32), device=device),
            bits=int(get("bits")), group_size=int(get("group_size")),
            shape=tuple(int(s) for s in get("shape")),
            batch_dims=int(get("batch_dims")), contract_dims=int(get("contract_dims")),
            dtype=dtype, rest_pad=int(get("rest_pad") or 0),
        )
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if tree is None:
        return None
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16 (JAX's): widening to f32 is exact
        arr = arr.astype(np.float32)
    t = torch.tensor(arr)
    if arr.dtype.kind == "f":
        t = t.to(dtype)
    return t.to(device)


def kv_cache_from_numpy(k, v, device="cpu", dtype: Optional[torch.dtype] = None):
    """A JAX ``[L, B, KH, D, S]`` KV cache -> the port's ``[L, B, KH, S, D]``
    :class:`~flexflow_tpu_torch.models.decoder.KVCache`."""
    from flexflow_tpu_torch.models.decoder import KVCache

    def conv(a):
        t = torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(a), 3, 4)))
        return t.to(device=device, dtype=dtype or t.dtype)

    return KVCache(k=conv(k), v=conv(v))
