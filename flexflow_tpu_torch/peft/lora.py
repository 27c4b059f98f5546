"""LoRA adapters: config, parameter init, merge, HF name mapping and the
HF-PEFT adapter format (port of ``flexflow_tpu/peft/lora.py``).

Adapters are stacked on a leading [N] axis (N = adapter slots). Per target
module m with base weight [D_in..., D_out...] the stacks are JAX's layout:

    a: [L, N, D_in_flat, r]   (normal / sqrt(D_in) init)
    b: [L, N, r, D_out_flat]  (zeros init: a fresh adapter is the identity)

applied as ``out += scaling * (x @ a) @ b`` with ``scaling = alpha / r``.

The decoder reads the stacks in another layout, built once by
:func:`route_lora`: per module ``a`` as [L, D_in, N*r] and ``b`` as
[L, N*r, D_out], in float32. One GEMM then gives every adapter's ``x @ a``
for every row, a weight over the N*r columns keeps each row's own adapter
times the scale and zeroes the others (JAX's [B, N] one-hot, applied on
the rank axis), and one GEMM with ``b`` gives the delta. Each adapter's weights are read once a step,
however many rows route to it, and no per-row copy of a weight exists.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from flexflow_tpu_torch.quant.weight_only import QuantizedArray
from flexflow_tpu_torch.specs import ModelSpec

Stacks = Dict[str, Dict[str, torch.Tensor]]

# HF PEFT target-module names -> the decoder's parameter keys
_HF_TO_KEY = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "wg",
    "up_proj": "wu",
    "down_proj": "wd",
    "fc1": "wu",
    "fc2": "wd",
    "out_proj": "wo",
}


def hf_module_to_key(name: str) -> str:
    return _HF_TO_KEY.get(name, name)


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """Rank, alpha and target modules of an adapter, and the optimizer that
    finetunes it (``peft/finetune.FinetuneSession``)."""

    rank: int = 16
    alpha: float = 16.0
    target_modules: Sequence[str] = ("wq", "wv")
    learning_rate: float = 1e-3
    optimizer: str = "sgd"  # "sgd" | "adam"

    def keys(self) -> Tuple[str, ...]:
        return tuple(hf_module_to_key(m) for m in self.target_modules)


def lora_scaling(cfg: LoraConfig) -> float:
    return cfg.alpha / cfg.rank


def _module_dims(spec: ModelSpec, key: str) -> Tuple[int, int]:
    d, hh, kh, dh, f = (spec.hidden_size, spec.num_heads, spec.num_kv_heads, spec.head_dim,
                        spec.intermediate_size)
    return {
        "wq": (d, hh * dh),
        "wk": (d, kh * dh),
        "wv": (d, kh * dh),
        "wo": (hh * dh, d),
        "wg": (d, f),
        "wu": (d, f),
        "wd": (f, d),
    }[key]


def init_lora_params(spec: ModelSpec, cfg: LoraConfig, num_adapters: int,
                     generator: torch.Generator, dtype=torch.float32, device="cpu") -> Stacks:
    """Stacked adapter weights, A drawn from ``generator`` (on its own
    device) module by module, B zero so fresh adapters are the identity."""
    out: Stacks = {}
    for mod in cfg.keys():
        d_in, d_out = _module_dims(spec, mod)
        a = torch.randn((spec.num_layers, num_adapters, d_in, cfg.rank), generator=generator,
                        device=generator.device) / math.sqrt(d_in)
        out[mod] = {"a": a.to(device=device, dtype=dtype),
                    "b": torch.zeros((spec.num_layers, num_adapters, cfg.rank, d_out),
                                     dtype=dtype, device=device)}
    return out


def merge_lora(spec: ModelSpec, params, lora: Stacks, adapter: int, cfg: LoraConfig):
    """The dense parameters with adapter ``adapter`` merged in:
    W' = W + scaling * A @ B, computed in float32, cast to W's dtype."""
    del spec
    scale = lora_scaling(cfg)
    layers = dict(params["layers"])
    for mod, ab in lora.items():
        w = layers[mod]
        if isinstance(w, QuantizedArray):
            raise ValueError(f"merge_lora needs dense parameters; {mod} is quantized")
        delta = torch.einsum("ldr,lrf->ldf", ab["a"][:, adapter].float(),
                             ab["b"][:, adapter].float()) * scale
        layers[mod] = (w.float() + delta.reshape(w.shape)).to(w.dtype)
    return {**params, "layers": layers}


class RoutedLora(NamedTuple):
    """The stacks in the decoder's routing layout (see the module
    docstring): ``a[m]`` [L, D_in, N*r], ``b[m]`` [L, N*r, D_out], float32."""

    a: Dict[str, torch.Tensor]
    b: Dict[str, torch.Tensor]
    rank: int
    num_adapters: int


def route_lora(lora: Stacks) -> RoutedLora:
    """JAX-layout stacks -> the decoder's routing layout (a float32 copy;
    widening bf16 stacks is exact). Every module must hold the same
    number of adapters at the same rank."""
    shapes = {(ab["a"].shape[1], ab["a"].shape[3]) for ab in lora.values()}
    if len(shapes) != 1:
        raise ValueError(f"adapter stacks disagree on (adapters, rank): {sorted(shapes)}")
    (n, r), = shapes
    a, b = {}, {}
    for mod, ab in lora.items():
        la, _, d_in, _ = ab["a"].shape
        a[mod] = (ab["a"].to(torch.float32, copy=True).permute(0, 2, 1, 3)
                  .reshape(la, d_in, n * r).contiguous())
        b[mod] = ab["b"].to(torch.float32, copy=True).reshape(la, n * r, ab["b"].shape[-1])
    return RoutedLora(a, b, r, n)


def unroute_lora(routed: RoutedLora) -> Stacks:
    """The routing layout back in JAX's stack layout (the inverse of
    :func:`route_lora`): per module ``a`` [L, N, D_in, r] and ``b`` [L, N,
    r, D_out], float32 copies of what the routed tensors hold now (a
    finetuned slot included)."""
    n, r = routed.num_adapters, routed.rank
    out: Stacks = {}
    for mod in routed.a:
        a, b = routed.a[mod], routed.b[mod]
        la, d_in, _ = a.shape
        out[mod] = {"a": a.reshape(la, d_in, n, r).permute(0, 2, 1, 3).contiguous(),
                    "b": b.reshape(la, n, r, b.shape[-1]).clone()}
    return out


def load_hf_adapter_config(adapter_dir: str) -> LoraConfig:
    """Read an HF PEFT ``adapter_config.json`` into a LoraConfig."""
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        cfg = json.load(f)
    return LoraConfig(
        rank=int(cfg.get("r", 8)),
        alpha=float(cfg.get("lora_alpha", cfg.get("r", 8))),
        target_modules=tuple(cfg.get("target_modules", ("q_proj", "v_proj"))),
    )


def load_hf_adapter_into_slot(adapter_dir: str, spec: ModelSpec, lora: Stacks, slot: int,
                              cfg: LoraConfig) -> Stacks:
    """Write an HF PEFT adapter's weights into slot ``slot`` of the stacks,
    in place; returns ``lora``.

    HF PEFT stores per layer ``lora_A.weight`` [r, D_in] and
    ``lora_B.weight`` [D_out, r] (torch's y = x W^T); each transposes into
    a [L, N, D_in, r] / b [L, N, r, D_out]. Read through the port's own
    safetensors reader."""
    from flexflow_tpu_torch.utils.hf_weights import LazyStateDict

    sd = LazyStateDict(adapter_dir)
    names = list(sd.keys())
    for mod in cfg.keys():
        hf_names = [h for h, k in _HF_TO_KEY.items() if k == mod]
        a_stack, b_stack = lora[mod]["a"], lora[mod]["b"]
        for layer in range(spec.num_layers):
            for name in names:
                if f"layers.{layer}." not in name or not any(h in name for h in hf_names):
                    continue
                if "lora_A" in name:
                    a_stack[layer, slot] = torch.from_numpy(sd[name].T.copy())
                elif "lora_B" in name:
                    b_stack[layer, slot] = torch.from_numpy(sd[name].T.copy())
    return lora


def export_hf_adapter(adapter_dir: str, spec: ModelSpec, lora: Stacks, slot: int,
                      cfg: LoraConfig, shard=None) -> None:
    """Write slot ``slot`` as an HF-PEFT-layout adapter directory
    (``adapter_config.json`` + ``adapter_model.safetensors``, float32).
    ``shard``: ``lora`` is a mesh rank's cut; every rank calls this, the
    stacks are gathered over each cut's group and rank 0 writes them."""
    from flexflow_tpu_torch.utils.hf_weights import save_safetensors

    if shard is not None:
        from flexflow_tpu_torch.parallel.sharding import gather_lora

        lora = gather_lora(spec, lora, shard)
        if shard.mesh.rank != 0:
            return

    os.makedirs(adapter_dir, exist_ok=True)
    key_to_hf: Dict[str, str] = {}
    for h, k in _HF_TO_KEY.items():
        key_to_hf.setdefault(k, h)
    tensors = {}
    for mod, ab in lora.items():
        hf = key_to_hf.get(mod, mod)
        block = "mlp" if mod in ("wg", "wu", "wd") else "self_attn"
        for layer in range(spec.num_layers):
            base = f"base_model.model.model.layers.{layer}.{block}.{hf}"
            tensors[f"{base}.lora_A.weight"] = ab["a"][layer, slot].float().T.cpu().numpy()
            tensors[f"{base}.lora_B.weight"] = ab["b"][layer, slot].float().T.cpu().numpy()
    save_safetensors(tensors, os.path.join(adapter_dir, "adapter_model.safetensors"))
    with open(os.path.join(adapter_dir, "adapter_config.json"), "w") as f:
        json.dump({"r": cfg.rank, "lora_alpha": cfg.alpha,
                   "target_modules": list(cfg.target_modules), "peft_type": "LORA"}, f)
