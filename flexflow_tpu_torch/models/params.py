"""Parameter dicts: random init, HuggingFace import, a streaming quantized
build, and carry-over from the JAX package (port of
``flexflow_tpu/models/params.py``).

Layout matches the JAX package: torch ``nn.Linear.weight`` [out, in] becomes
[in, ...out] (contraction on the leading axis), and every per-layer leaf is
stacked on a leading [num_layers, ...] axis. A MoE layer adds ``router``
[L, D, E] and expert stacks ``wg`` / ``wu`` [L, E, D, F], ``wd`` [L, E, F, D].

``build_params`` assembles the stacked leaves layer by layer and, with
``bits``, quantizes each layer's slab as it comes into a carrier allocated
once: the full-precision tree never exists. The HF loader's
quantize-on-load and ``init_quantized_params`` (random weights for a model
whose full-precision tree does not fit the card, e.g. Mixtral-8x7B) go
through it. With ``host_layers`` it writes the stack into (pinned) host
memory for CPU offload, one layer at a time.

Under a device mesh (``mesh=``, a ``parallel/mesh.Mesh``) every function
here returns this rank's tree (``parallel/sharding``): each leaf or layer slab is
cut as soon as it is made, a quantized slab after it is quantized whole, so
no rank ever holds more than one leaf or layer of the whole model, and the
result equals ``shard_params`` of the one-device tree from the same inputs.
Under pipeline stages a rank builds only its stage's layers and the top
leaves its stage runs (``sharding.stage_keeps``), so it never holds the
whole stack (random draws still run through every layer in order, so a
stage's values are the one-device tree's).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from flexflow_tpu_torch.config import config as _ffconfig
from flexflow_tpu_torch.models.decoder import fuse_qkv_params
from flexflow_tpu_torch.models.layer_store import leaf_fields, host_empty
from flexflow_tpu_torch.parallel.sharding import layer_shard, rank_shard, shard_leaf, stage_keeps
from flexflow_tpu_torch.quant.weight_only import QuantizedArray, layer_quant_layout, quantize
from flexflow_tpu_torch.specs import ModelSpec

Params = Dict[str, Any]
# a leaf's init: "ones", "zeros", or (fan_in, fan_out) of a Glorot normal draw
Init = Union[str, Tuple[int, int]]


def _leaves(spec: ModelSpec) -> Tuple[Dict[str, Tuple[tuple, Init]], Dict[str, Tuple[tuple, Init]]]:
    """(per-layer leaves, top-level leaves) as name -> (shape, init), a
    per-layer shape without its [L] axis, in the order they are drawn."""
    d, hh, kh, dh, f = (spec.hidden_size, spec.num_heads, spec.num_kv_heads, spec.head_dim,
                        spec.intermediate_size)
    layer: Dict[str, Tuple[tuple, Init]] = {
        "ln1_scale": ((d,), "ones"),
        "ln2_scale": ((d,), "ones"),
        "wq": ((d, hh, dh), (d, hh * dh)),
        "wk": ((d, kh, dh), (d, kh * dh)),
        "wv": ((d, kh, dh), (d, kh * dh)),
        "wo": ((hh, dh, d), (hh * dh, d)),
    }
    layernorm_bias = spec.norm == "layernorm" and spec.norm_bias
    if layernorm_bias:
        layer["ln1_bias"] = layer["ln2_bias"] = ((d,), "zeros")
    if spec.qkv_bias:
        layer["bq"] = ((hh, dh), "zeros")
        layer["bk"] = layer["bv"] = ((kh, dh), "zeros")
    if spec.attn_out_bias:
        layer["bo"] = ((d,), "zeros")
    if spec.moe is not None:
        e = spec.moe.num_experts
        layer["router"] = ((d, e), (d, e))
        layer["wg"] = ((e, d, f), (d, f))
        layer["wu"] = ((e, d, f), (d, f))
        layer["wd"] = ((e, f, d), (f, d))
    else:
        if spec.act == "silu_gate":
            layer["wg"] = ((d, f), (d, f))
        layer["wu"] = ((d, f), (d, f))
        layer["wd"] = ((f, d), (f, d))
        if spec.mlp_bias:
            layer["bu"] = ((f,), "zeros")
            layer["bd"] = ((d,), "zeros")
    top: Dict[str, Tuple[tuple, Init]] = {
        "embed_tokens": ((spec.vocab_size, d), (spec.vocab_size, d)),
        "final_norm_scale": ((d,), "ones"),
    }
    if layernorm_bias:
        top["final_norm_bias"] = ((d,), "zeros")
    if spec.pos == "learned":
        top["embed_pos"] = ((spec.max_position_embeddings + spec.learned_pos_offset, d),
                            (spec.max_position_embeddings, d))
    if not spec.tie_word_embeddings:
        top["lm_head"] = ((d, spec.vocab_size), (d, spec.vocab_size))
    return layer, top


def _maker(generator: Union[int, torch.Generator], dtype, device):
    """make(shape, init): a leaf drawn in order from one ``torch.Generator``
    (Glorot normal in float32, then cast to ``dtype``; ones; zeros)."""
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)

    def make(shape, init: Init) -> torch.Tensor:
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        fan_in, fan_out = init
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * float(np.sqrt(2.0 / (fan_in + fan_out)))).to(dtype)

    return make


def init_params(spec: ModelSpec, generator: Union[int, torch.Generator] = 0,
                dtype=torch.float32, device="cpu", *, host_layers: bool = False,
                mesh=None) -> Params:
    """Random-initialized parameters (Glorot normal for matmuls and the MoE
    router, ones for norm scales, zeros for biases), each whole [L, ...]
    leaf drawn in order from one ``torch.Generator``.

    ``host_layers``: the layer stack goes to host memory (pinned when
    ``device`` is a CUDA device), drawn on ``device`` one layer at a time
    in ``init_quantized_params``' order (top leaves first, then layer by
    layer, leaf by leaf), so the device never holds more than one layer:
    the values differ from the whole-leaf draw. A resident engine built
    from the same result holds the same bits. ``mesh``: this rank's cut,
    each leaf cut as it is drawn."""
    if host_layers:
        return init_quantized_params(spec, generator, bits=None, dtype=dtype, device=device,
                                     host_layers=True, mesh=mesh)
    device = torch.device(device)
    make = _maker(generator, dtype, device)
    layer_leaves, top_leaves = _leaves(spec)
    shard = layer_shard(spec, mesh, None)
    layers = {n: shard_leaf(n, make((spec.num_layers, *shape), init), shard)
              for n, (shape, init) in layer_leaves.items()}
    tied = "lm_head" not in top_leaves
    params = {n: shard_leaf(n, make(shape, init), shard, top=True)
              for n, (shape, init) in top_leaves.items()}
    params = {n: v for n, v in params.items() if stage_keeps(n, shard, tied)}
    params["layers"] = layers
    return params


def init_quantized_params(spec: ModelSpec, generator: Union[int, torch.Generator] = 0, *,
                          bits: Optional[int] = 8, group_size: int = 128, dtype=torch.bfloat16,
                          device="cpu", host_layers: bool = False, mesh=None) -> Params:
    """Random-initialized parameters with every matmul weight quantized as
    it is drawn (``quantize_params``' layout): ``init_params``'
    distributions, drawn layer by layer and leaf by leaf, so peak memory is
    the carriers plus one layer's float32 slab of one leaf (2 GB for one
    Mixtral-8x7B expert projection) instead of the full-precision tree.
    The port's counterpart of ``bench_70b.py``'s ``_init_quantized_streaming``.
    ``bits=None`` draws the same way without quantizing; ``host_layers``
    writes the layer stack into host memory (``build_params``), with the
    same values as on the device. ``mesh``: this rank's cut."""
    device = torch.device(device)
    make = _maker(generator, torch.float32, device)
    layer_leaves, top_leaves = _leaves(spec)

    def layer(_i):
        for name, (shape, init) in layer_leaves.items():
            yield name, make(shape, init)

    top = {n: make(shape, init) for n, (shape, init) in top_leaves.items()}
    return build_params(spec, top, layer, dtype=dtype, device=device, bits=bits,
                        group_size=group_size, host_layers=host_layers, mesh=mesh)


def _leaf(x, device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype if x.is_floating_point() else x.dtype)
    return params_from_numpy(x, device, dtype)


def _stacked(one, num_layers: int, empty):
    """An empty [L, ...] leaf for the one-layer leaf ``one`` (a ``[1, ...]``
    tensor or carrier; ``empty(shape, dtype)`` allocates each field)."""
    def stacked(t):
        return None if t is None else empty((num_layers, *t.shape[1:]), t.dtype)

    if isinstance(one, QuantizedArray):
        return dataclasses.replace(one, q=stacked(one.q), scale=stacked(one.scale),
                                   offset=stacked(one.offset),
                                   shape=(num_layers, *one.shape[1:]))
    return stacked(one)


def build_params(spec: ModelSpec, top: Mapping[str, Any],
                 layer: Callable[[int], Iterable[Tuple[str, Any]]], *, dtype, device,
                 bits: Optional[int] = None, group_size: int = 128,
                 host_layers: bool = False, mesh=None, hybrid_ffn: bool = False) -> Params:
    """The decoder's parameters on ``device``, built one layer at a time.

    ``layer(i)`` yields layer i's ``(name, slab)`` pairs (numpy arrays or
    tensors, without the [L] axis); each slab is cast to ``dtype`` and
    written into its [L, ...] leaf, allocated at layer 0. With ``bits`` a
    slab that ``quantize_params`` would quantize is quantized on its own and
    written into a stacked carrier instead, byte for byte what quantizing
    the whole stacked leaf gives. ``top`` holds the other leaves (the
    lm_head quantized whole with ``bits``).

    ``host_layers`` (CPU offload): the [L, ...] leaves and carriers live in
    host memory, page-locked when ``device`` is a CUDA device
    (``models/layer_store.pinned_empty``); each layer is made (and
    quantized) on ``device``, fused there as the engine fuses a resident
    stack (wqkv / wgu, ``decoder.fuse_qkv_params``, under
    ``config.fuse_qkv``) and copied out, so the device holds one layer at a
    time, the host holds one copy of the stack, and the values are those of
    the resident engine's. ``top`` stays on ``device``.

    ``mesh``: this rank's tree; each slab is cut once it is made (and
    quantized), the top leaves before they reach ``device`` (a quantized
    lm_head after it is quantized whole); with ``host_layers`` the rank
    fuses its own cut and pins only that; under pipeline stages only the
    stage's layers are made (``layer(i)`` is still iterated for every i, in
    order) and only its top leaves kept. ``hybrid_ffn``: the FFN cut over
    the model and data ranks (``parallel/sharding``)."""
    device = torch.device(device)
    shard = layer_shard(spec, mesh, bits, hybrid_ffn=hybrid_ffn)
    lo, hi = (0, spec.num_layers) if shard is None or shard.layers is None else shard.layers
    n_layers = hi - lo
    # a slab is one layer: cut over the model axis only
    slab_shard = shard if lo == 0 and hi == spec.num_layers else dataclasses.replace(
        shard, layers=None)
    fuse = host_layers and _ffconfig.fuse_qkv
    if host_layers:
        pin = device.type == "cuda"

        def empty(shape, dt):
            return host_empty(shape, dt, pin)
    else:
        def empty(shape, dt):
            return torch.empty(shape, dtype=dt, device=device)
    layers: Params = {}
    for i in range(spec.num_layers):
        if not lo <= i < hi:  # another stage's layer: drawn (in order), not kept
            for _ in layer(i):
                pass
            continue
        one: Params = {}  # layer i's leaves as [1, ...]
        for name, slab in layer(i):
            t = _leaf(slab, device, dtype)[None]
            layout = layer_quant_layout(name, t.dim()) if bits else None
            if layout is not None:
                t = quantize(t, bits, group_size, batch_dims=layout[0],
                             contract_dims=layout[1], compute_dtype=dtype)
            one[name] = shard_leaf(name, t, slab_shard)
        if fuse:
            one = fuse_qkv_params(spec, {"layers": one}, shard)["layers"]
        for name, leaf in one.items():
            if name not in layers:
                layers[name] = _stacked(leaf, n_layers, empty)
            for dst, src in zip(leaf_fields(layers[name]), leaf_fields(leaf)):
                dst[i - lo] = src[0]
        del one
    params = {}
    tied = "lm_head" not in top
    for k, v in top.items():
        if not stage_keeps(k, shard, tied):
            continue
        if bits and k == "lm_head":
            params[k] = shard_leaf(k, quantize(_leaf(v, device, dtype), bits, group_size,
                                               compute_dtype=dtype), shard, top=True)
        else:
            params[k] = _leaf(shard_leaf(k, _leaf(v, "cpu", dtype), shard, top=True), device,
                              dtype)
    params["layers"] = layers
    return params


# ---------------------------------------------------------------------------
# HF state-dict import: per architecture, (top-level leaves, one layer's leaves)
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


class _SD:
    """State-dict accessor: tensors as numpy arrays."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = sd

    def __contains__(self, name: str) -> bool:
        return name in self.sd

    def get(self, name: str) -> np.ndarray:
        return _np(self.sd[name])


def _lin(w: np.ndarray) -> np.ndarray:
    """torch Linear [out, in] -> ours [in, out]."""
    return np.ascontiguousarray(w.T)


def _heads(w: np.ndarray, n: int, dh: int) -> np.ndarray:
    """torch proj weight [n*dh, in] -> ours [in, n, dh]."""
    return np.ascontiguousarray(w.reshape(n, dh, -1).transpose(2, 0, 1))


def _in_heads(w: np.ndarray) -> np.ndarray:
    """[n, dh, in] rows of a fused projection -> ours [in, n, dh]."""
    return np.ascontiguousarray(w.transpose(2, 0, 1))


def _llama_top(spec: ModelSpec, s: _SD) -> Params:
    top = {"embed_tokens": s.get("model.embed_tokens.weight"),
           "final_norm_scale": s.get("model.norm.weight")}
    if not spec.tie_word_embeddings and "lm_head.weight" in s:
        top["lm_head"] = _lin(s.get("lm_head.weight"))
    return top


def _llama_attn(spec: ModelSpec, s: _SD, p: str) -> Params:
    d, hh, kh, dh = spec.hidden_size, spec.num_heads, spec.num_kv_heads, spec.head_dim
    out = {
        "ln1_scale": s.get(p + "input_layernorm.weight"),
        "ln2_scale": s.get(p + "post_attention_layernorm.weight"),
        "wq": _heads(s.get(p + "self_attn.q_proj.weight"), hh, dh),
        "wk": _heads(s.get(p + "self_attn.k_proj.weight"), kh, dh),
        "wv": _heads(s.get(p + "self_attn.v_proj.weight"), kh, dh),
        "wo": s.get(p + "self_attn.o_proj.weight").T.reshape(hh, dh, d),
    }
    if spec.qkv_bias:
        out["bq"] = s.get(p + "self_attn.q_proj.bias").reshape(hh, dh)
        out["bk"] = s.get(p + "self_attn.k_proj.bias").reshape(kh, dh)
        out["bv"] = s.get(p + "self_attn.v_proj.bias").reshape(kh, dh)
    return out


def _llama_layer(spec: ModelSpec, s: _SD, i: int) -> Params:
    p = f"model.layers.{i}."
    return {**_llama_attn(spec, s, p),
            "wg": _lin(s.get(p + "mlp.gate_proj.weight")),
            "wu": _lin(s.get(p + "mlp.up_proj.weight")),
            "wd": _lin(s.get(p + "mlp.down_proj.weight"))}


def _mixtral_layer(spec: ModelSpec, s: _SD, i: int) -> Params:
    p = f"model.layers.{i}."
    m = p + "block_sparse_moe."
    experts = range(spec.moe.num_experts)
    return {**_llama_attn(spec, s, p),
            "router": _lin(s.get(m + "gate.weight")),
            "wg": np.stack([_lin(s.get(m + f"experts.{j}.w1.weight")) for j in experts]),
            "wu": np.stack([_lin(s.get(m + f"experts.{j}.w3.weight")) for j in experts]),
            "wd": np.stack([_lin(s.get(m + f"experts.{j}.w2.weight")) for j in experts])}


def _opt_top(spec: ModelSpec, s: _SD) -> Params:
    top = {"embed_tokens": s.get("model.decoder.embed_tokens.weight"),
           "embed_pos": s.get("model.decoder.embed_positions.weight")}
    if "model.decoder.final_layer_norm.weight" in s:
        top["final_norm_scale"] = s.get("model.decoder.final_layer_norm.weight")
        top["final_norm_bias"] = s.get("model.decoder.final_layer_norm.bias")
    if not spec.tie_word_embeddings and "lm_head.weight" in s:
        top["lm_head"] = _lin(s.get("lm_head.weight"))
    return top


def _opt_layer(spec: ModelSpec, s: _SD, i: int) -> Params:
    d, hh, dh = spec.hidden_size, spec.num_heads, spec.head_dim
    p = f"model.decoder.layers.{i}."
    return {
        "ln1_scale": s.get(p + "self_attn_layer_norm.weight"),
        "ln1_bias": s.get(p + "self_attn_layer_norm.bias"),
        "ln2_scale": s.get(p + "final_layer_norm.weight"),
        "ln2_bias": s.get(p + "final_layer_norm.bias"),
        "wq": _heads(s.get(p + "self_attn.q_proj.weight"), hh, dh),
        "bq": s.get(p + "self_attn.q_proj.bias").reshape(hh, dh),
        "wk": _heads(s.get(p + "self_attn.k_proj.weight"), hh, dh),
        "bk": s.get(p + "self_attn.k_proj.bias").reshape(hh, dh),
        "wv": _heads(s.get(p + "self_attn.v_proj.weight"), hh, dh),
        "bv": s.get(p + "self_attn.v_proj.bias").reshape(hh, dh),
        "wo": s.get(p + "self_attn.out_proj.weight").T.reshape(hh, dh, d),
        "bo": s.get(p + "self_attn.out_proj.bias"),
        "wu": _lin(s.get(p + "fc1.weight")),
        "bu": s.get(p + "fc1.bias"),
        "wd": _lin(s.get(p + "fc2.weight")),
        "bd": s.get(p + "fc2.bias"),
    }


def _falcon_top(spec: ModelSpec, s: _SD) -> Params:
    top = {"embed_tokens": s.get("transformer.word_embeddings.weight"),
           "final_norm_scale": s.get("transformer.ln_f.weight"),
           "final_norm_bias": s.get("transformer.ln_f.bias")}
    if "lm_head.weight" in s:
        top["lm_head"] = _lin(s.get("lm_head.weight"))
    return top


def _falcon_layer(spec: ModelSpec, s: _SD, i: int) -> Params:
    d, hh, kh, dh = spec.hidden_size, spec.num_heads, spec.num_kv_heads, spec.head_dim
    new_arch = spec.num_ln_in_parallel_attn == 2
    p = f"transformer.h.{i}."
    qkv = s.get(p + "self_attention.query_key_value.weight")  # [(..), d]
    if new_arch:  # interleaved per kv group: [KH, q_per_kv + 2, Dh, d]
        g = spec.q_per_kv
        w = qkv.reshape(kh, g + 2, dh, d)
        wq, wk, wv = w[:, :g].reshape(kh * g, dh, d), w[:, g], w[:, g + 1]
    elif kh == 1:
        wq = qkv[: hh * dh].reshape(hh, dh, d)
        wk = qkv[hh * dh: (hh + 1) * dh].reshape(1, dh, d)
        wv = qkv[(hh + 1) * dh:].reshape(1, dh, d)
    else:
        w = qkv.reshape(hh, 3, dh, d)
        wq, wk, wv = w[:, 0], w[:, 1], w[:, 2]
    layer = {
        "wq": _in_heads(wq), "wk": _in_heads(wk), "wv": _in_heads(wv),
        "wo": s.get(p + "self_attention.dense.weight").T.reshape(hh, dh, d),
        "wu": _lin(s.get(p + "mlp.dense_h_to_4h.weight")),
        "wd": _lin(s.get(p + "mlp.dense_4h_to_h.weight")),
    }
    if new_arch:
        layer.update(ln1_scale=s.get(p + "ln_attn.weight"), ln1_bias=s.get(p + "ln_attn.bias"),
                     ln2_scale=s.get(p + "ln_mlp.weight"), ln2_bias=s.get(p + "ln_mlp.bias"))
    else:
        layer.update(ln1_scale=s.get(p + "input_layernorm.weight"),
                     ln1_bias=s.get(p + "input_layernorm.bias"))
    return layer


def _mpt_top(spec: ModelSpec, s: _SD) -> Params:
    return {"embed_tokens": s.get("transformer.wte.weight"),
            "final_norm_scale": s.get("transformer.norm_f.weight")}


def _mpt_layer(spec: ModelSpec, s: _SD, i: int) -> Params:
    d, hh, dh = spec.hidden_size, spec.num_heads, spec.head_dim
    p = f"transformer.blocks.{i}."
    qkv = s.get(p + "attn.Wqkv.weight")  # [3d, d] fused q|k|v
    return {
        "ln1_scale": s.get(p + "norm_1.weight"),
        "ln2_scale": s.get(p + "norm_2.weight"),
        "wq": _in_heads(qkv[:d].reshape(hh, dh, d)),
        "wk": _in_heads(qkv[d: 2 * d].reshape(hh, dh, d)),
        "wv": _in_heads(qkv[2 * d:].reshape(hh, dh, d)),
        "wo": s.get(p + "attn.out_proj.weight").T.reshape(hh, dh, d),
        "wu": _lin(s.get(p + "ffn.up_proj.weight")),
        "wd": _lin(s.get(p + "ffn.down_proj.weight")),
    }


def _gptbigcode_top(spec: ModelSpec, s: _SD) -> Params:
    return {"embed_tokens": s.get("transformer.wte.weight"),
            "embed_pos": s.get("transformer.wpe.weight"),
            "final_norm_scale": s.get("transformer.ln_f.weight"),
            "final_norm_bias": s.get("transformer.ln_f.bias")}


def _gptbigcode_layer(spec: ModelSpec, s: _SD, i: int) -> Params:
    d, hh, kh, dh = spec.hidden_size, spec.num_heads, spec.num_kv_heads, spec.head_dim
    p = f"transformer.h.{i}."
    cattn_w = s.get(p + "attn.c_attn.weight")  # [d + 2*kh*dh, d]
    cattn_b = s.get(p + "attn.c_attn.bias")
    kv = d + kh * dh
    return {
        "ln1_scale": s.get(p + "ln_1.weight"),
        "ln1_bias": s.get(p + "ln_1.bias"),
        "ln2_scale": s.get(p + "ln_2.weight"),
        "ln2_bias": s.get(p + "ln_2.bias"),
        "wq": _in_heads(cattn_w[:d].reshape(hh, dh, d)),
        "bq": cattn_b[:d].reshape(hh, dh),
        "wk": _in_heads(cattn_w[d:kv].reshape(kh, dh, d)),
        "bk": cattn_b[d:kv].reshape(kh, dh),
        "wv": _in_heads(cattn_w[kv:].reshape(kh, dh, d)),
        "bv": cattn_b[kv:].reshape(kh, dh),
        "wo": s.get(p + "attn.c_proj.weight").T.reshape(hh, dh, d),
        "bo": s.get(p + "attn.c_proj.bias"),
        "wu": _lin(s.get(p + "mlp.c_fc.weight")),
        "bu": s.get(p + "mlp.c_fc.bias"),
        "wd": _lin(s.get(p + "mlp.c_proj.weight")),
        "bd": s.get(p + "mlp.c_proj.bias"),
    }


_CONVERTERS = {
    "LlamaForCausalLM": (_llama_top, _llama_layer),
    "MixtralForCausalLM": (_llama_top, _mixtral_layer),
    "OPTForCausalLM": (_opt_top, _opt_layer),
    "FalconForCausalLM": (_falcon_top, _falcon_layer),
    "MPTForCausalLM": (_mpt_top, _mpt_layer),
    "GPTBigCodeForCausalLM": (_gptbigcode_top, _gptbigcode_layer),
}


def convert_hf_state_dict(spec: ModelSpec, sd: Mapping[str, Any], dtype=torch.float32,
                          device="cpu", *, bits: Optional[int] = None,
                          group_size: int = 128, host_layers: bool = False,
                          mesh=None) -> Params:
    """HuggingFace state dict -> the decoder's parameters on ``device``, for
    every architecture the JAX package converts (LLaMA, Mixtral, OPT,
    Falcon, MPT, GPTBigCode), one layer at a time (``build_params``); with
    ``bits`` every matmul weight is quantized as its layer is converted,
    with ``host_layers`` the layer stack goes to (pinned) host memory,
    with ``mesh`` this rank's cut of each layer."""
    top, layer = _CONVERTERS[spec.arch]
    s = _SD(sd)
    return build_params(spec, top(spec, s), lambda i: layer(spec, s, i).items(), dtype=dtype,
                        device=device, bits=bits, group_size=group_size,
                        host_layers=host_layers, mesh=mesh)


# ---------------------------------------------------------------------------
# carry-over from the JAX package (numpy in, no JAX import)
# ---------------------------------------------------------------------------

_QFIELDS = ("q", "scale", "offset", "bits", "group_size", "shape", "batch_dims",
            "contract_dims", "rest_pad")


def _is_quantized(leaf) -> bool:
    if isinstance(leaf, Mapping):
        return "q" in leaf and "scale" in leaf and "bits" in leaf
    return all(hasattr(leaf, f) for f in ("q", "scale", "bits", "group_size"))


def params_from_numpy(tree, device="cpu", dtype=torch.float32, *, spec=None, mesh=None):
    """Turn a parameter tree of numpy arrays (e.g. the JAX package's params
    after ``np.asarray`` on each leaf) into the port's tensors on ``device``.

    Float leaves (JAX's bfloat16 included) are cast to ``dtype``. Quantized
    leaves, given as objects or dicts with ``q/scale/offset/bits/group_size/
    shape/batch_dims/contract_dims/rest_pad``, keep their carriers byte for
    byte and get ``dtype`` as their compute dtype.

    ``mesh`` (with the model's ``spec``): this rank's tree, each leaf cut on
    the host as it is converted, before it reaches ``device`` (under
    pipeline stages only the stage's layers and top leaves are converted).
    """
    if mesh is not None:
        if spec is None:
            raise ValueError("params_from_numpy(mesh=) needs the model's spec")
        layers = tree["layers"]
        int4 = [_is_quantized(layers.get(n)) and int(_field(layers[n], "bits")) == 4
                for n in ("wo", "wd")]
        shard = rank_shard(spec, mesh, int4_wo=int4[0], int4_wd=int4[1])

        def cut(name, leaf, top):
            if not top and shard.layers is not None:  # the stage's layers only
                leaf = _numpy_stage(leaf, *shard.layers)
            return _to(shard_leaf(name, params_from_numpy(leaf, "cpu", dtype), shard, top=top),
                       torch.device(device))

        tied = "lm_head" not in tree
        out = {k: cut(k, v, True) for k, v in tree.items()
               if k != "layers" and stage_keeps(k, shard, tied)}
        out["layers"] = {k: cut(k, v, False) for k, v in layers.items()}
        return out
    device = torch.device(device)
    if _is_quantized(tree):
        def get(f):
            return _field(tree, f)
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


def _numpy_stage(leaf, lo: int, hi: int):
    """Layers [lo, hi) of a numpy ``[L, ...]`` leaf or quantized carrier
    (object or dict), before it is converted."""
    if leaf is None:
        return None
    if _is_quantized(leaf):
        out = {f: _field(leaf, f) for f in _QFIELDS}
        for f in ("q", "scale", "offset"):
            if out[f] is not None:
                out[f] = np.asarray(out[f])[lo:hi]
        out["shape"] = (hi - lo, *tuple(int(n) for n in out["shape"])[1:])
        return out
    return np.asarray(leaf)[lo:hi]


def _field(leaf, name: str):
    """A quantized leaf's field, given as an object or a dict."""
    return leaf.get(name) if isinstance(leaf, Mapping) else getattr(leaf, name, None)


def _to(x, device):
    return x.to(device) if isinstance(x, (torch.Tensor, QuantizedArray)) else x


def lora_from_numpy(tree, device="cpu", dtype=torch.float32):
    """Turn the JAX package's LoRA adapter stacks ({module: {"a": [L, N,
    D_in, r], "b": [L, N, r, D_out]}}, numpy leaves) into the port's tensors
    on ``device``, cast to ``dtype`` (bf16 leaves widened exactly first, as
    ``params_from_numpy`` does)."""
    out = {}
    for mod, ab in tree.items():
        if set(ab) != {"a", "b"} or np.ndim(ab["a"]) != 4 or np.ndim(ab["b"]) != 4:
            raise ValueError(f"{mod}: expected {{'a': [L, N, D_in, r], 'b': [L, N, r, D_out]}}")
        out[mod] = params_from_numpy(dict(ab), device, dtype)
    return out


def kv_cache_from_numpy(k, v, device="cpu", dtype: Optional[torch.dtype] = None):
    """A JAX ``[L, B, KH, D, S]`` KV cache -> the port's ``[L, B, KH, S, D]``
    :class:`~flexflow_tpu_torch.models.decoder.KVCache`."""
    from flexflow_tpu_torch.models.decoder import KVCache

    def conv(a):
        t = torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(a), 3, 4)))
        return t.to(device=device, dtype=dtype or t.dtype)

    return KVCache(k=conv(k), v=conv(v))
