"""A (verifier, draft) pair for speculative decoding with random weights
(port of ``benchmarks/spec_pair.py``: ``embed_draft_in_verifier`` and its
check).

Two independently random models never agree, so a random draft would accept
about nothing and leave the accept/commit path unexercised. The verifier
here embeds the draft: a full-size model (every weight byte is streamed and
every product runs) whose weights are block-structured so that its extra
hidden dims, heads, FFN columns and layers add exactly zero to the residual
stream:

- ``embed_tokens[:, dd:] = 0``: the hidden state lives in the first ``dd`` dims;
- layers ``l < Ld`` hold the draft's blocks in the top-left corner of each
  projection and zeros elsewhere; RMSNorm scales carry a ``sqrt(dd / dv)``
  correction, since the norm averages over the full, mostly zero, width;
- layers ``l >= Ld`` have zero projections: their attention and MLP outputs
  are zero and the residual passes through.

The verifier then computes the draft's function (up to the norm epsilon);
quantizing the verifier makes the two differ by the quantization error.
Needs LLaMA-style specs: rmsnorm, silu_gate MLP, rope, no biases, one
head_dim, vocabulary and epsilon.

The verifier is built layer by layer on the device of the draft's weights
(or ``device``), quantizing each layer as it goes when ``bits`` is given, so
no full-precision copy of the whole verifier is ever held.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from flexflow_tpu_torch.quant.weight_only import QuantizedArray, quantize
from flexflow_tpu_torch.specs import ModelSpec


def check_pair(dspec: ModelSpec, vspec: ModelSpec) -> None:
    """Raise ValueError unless ``vspec`` can embed ``dspec``."""
    def need(cond, what):
        if not cond:
            raise ValueError(f"cannot embed the draft in the verifier: {what}")

    need(dspec.norm == vspec.norm == "rmsnorm", "rmsnorm only")
    need(dspec.act == vspec.act == "silu_gate", "silu_gate MLP only")
    need(dspec.pos == vspec.pos == "rope", "rope only")
    need(dspec.head_dim == vspec.head_dim, "head_dim differs")
    need(dspec.rope_theta == vspec.rope_theta, "rope_theta differs")
    need(dspec.vocab_size == vspec.vocab_size, "vocabulary differs")
    need(not dspec.qkv_bias and not vspec.qkv_bias, "qkv bias")
    need(dspec.hidden_size <= vspec.hidden_size, "draft wider than verifier")
    need(dspec.num_layers <= vspec.num_layers, "draft deeper than verifier")
    need(dspec.num_heads <= vspec.num_heads, "draft has more heads")
    need(dspec.num_kv_heads <= vspec.num_kv_heads, "draft has more KV heads")
    need(dspec.intermediate_size <= vspec.intermediate_size, "draft FFN wider")
    need(dspec.norm_eps == vspec.norm_eps, "norm_eps differs")
    need(dspec.embed_scale == vspec.embed_scale == 1.0, "embed_scale != 1")
    # draft head i must map to draft KV head i // G in both models
    need(dspec.num_heads * vspec.num_kv_heads == vspec.num_heads * dspec.num_kv_heads,
         "GQA group mismatch")


def embed_draft_in_verifier(dspec: ModelSpec, dparams, vspec: ModelSpec, *,
                            bits: Optional[int] = None, group_size: int = 128,
                            dtype=torch.bfloat16, device=None):
    """Verifier params computing the draft's function at ``vspec``'s size.

    Float leaves come out in ``dtype``. With ``bits`` (4 or 8) every matmul
    weight (per-layer projections and the lm_head) is a QuantizedArray with
    the carriers ``quantize_params`` gives the full verifier, built one layer
    at a time.
    """
    check_pair(dspec, vspec)
    dev = torch.device(device) if device is not None else dparams["embed_tokens"].device
    dd, dv = dspec.hidden_size, vspec.hidden_size
    ld, lv = dspec.num_layers, vspec.num_layers
    hd, hv = dspec.num_heads, vspec.num_heads
    kd, kv = dspec.num_kv_heads, vspec.num_kv_heads
    fd, fv = dspec.intermediate_size, vspec.intermediate_size
    dh = dspec.head_dim
    alpha = math.sqrt(dd / dv)  # rmsnorm width correction
    dl = dparams["layers"]

    def f32(t):
        return t.to(device=dev, dtype=torch.float32)

    # name -> (verifier unit shape, index of the draft block, contract_dims)
    units = {
        "wq": ((dv, hv, dh), (slice(0, dd), slice(0, hd)), 1),
        "wk": ((dv, kv, dh), (slice(0, dd), slice(0, kd)), 1),
        "wv": ((dv, kv, dh), (slice(0, dd), slice(0, kd)), 1),
        "wo": ((hv, dh, dv), (slice(0, hd), slice(None), slice(0, dd)), 2),
        "wg": ((dv, fv), (slice(0, dd), slice(0, fd)), 1),
        "wu": ((dv, fv), (slice(0, dd), slice(0, fd)), 1),
        "wd": ((fv, dv), (slice(0, fd), slice(0, dd)), 1),
    }

    def finish(name, shape, leaves, contract_dims):
        """Stack per-layer units (quantized or not) into one [L, ...] leaf."""
        if bits is None:
            return torch.stack(leaves).to(dtype)
        q0 = leaves[0]
        return QuantizedArray(
            q=torch.cat([u.q for u in leaves]), scale=torch.cat([u.scale for u in leaves]),
            offset=None if q0.offset is None else torch.cat([u.offset for u in leaves]),
            bits=q0.bits, group_size=q0.group_size, shape=(lv, *shape), batch_dims=1,
            contract_dims=contract_dims, dtype=dtype, rest_pad=q0.rest_pad)

    layers = {}
    for name, (shape, block, cdims) in units.items():
        leaves = []
        for l in range(lv):
            unit = torch.zeros(shape, dtype=torch.float32, device=dev)
            if l < ld:
                unit[block] = f32(dl[name][l])
            if bits is not None:
                unit = quantize(unit[None], bits, group_size, batch_dims=1,
                                contract_dims=cdims, compute_dtype=dtype)
            leaves.append(unit)
        layers[name] = finish(name, shape, leaves, cdims)
        del leaves
    for name in ("ln1_scale", "ln2_scale"):
        # the extra layers' norm scales do not matter (their outputs are
        # zero) but stay 1 so activations stay finite
        scale = torch.ones((lv, dv), dtype=torch.float32, device=dev)
        scale[:ld] = 0.0
        scale[:ld, :dd] = f32(dl[name]) * alpha
        layers[name] = scale.to(dtype)

    head = dparams.get("lm_head")
    head = f32(dparams["embed_tokens"]).T if head is None else f32(head)  # tied draft
    lm_head = torch.zeros((dv, vspec.vocab_size), dtype=torch.float32, device=dev)
    lm_head[:dd] = head
    if bits is not None:
        lm_head = quantize(lm_head, bits, group_size, compute_dtype=dtype)
    else:
        lm_head = lm_head.to(dtype)
    embed = torch.zeros((vspec.vocab_size, dv), dtype=torch.float32, device=dev)
    embed[:, :dd] = f32(dparams["embed_tokens"])
    final = torch.zeros((dv,), dtype=torch.float32, device=dev)
    final[:dd] = f32(dparams["final_norm_scale"]) * alpha
    return {"embed_tokens": embed.to(dtype), "layers": layers,
            "final_norm_scale": final.to(dtype), "lm_head": lm_head}
