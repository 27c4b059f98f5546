"""Fine-grained, layer-by-layer alignment against HuggingFace forward hooks
(port of ``flexflow_tpu/utils/alignment.py``).

The reference diffs the per-op tensors that ``--inference-debugging`` dumps
against tensors captured from HF forward hooks, step by step: the tool that
localizes a numerics regression to the op that caused it, where a
whole-model logit comparison only says that something diverged.

- :func:`hf_layer_traces` hooks every decoder block of an HF model (found
  as the first module list of blocks with parameters) and captures each
  block's output hidden state and the final logits;
- :func:`compare_with_hf` runs ``debug_dump.forward_with_traces`` on the
  same tokens and reports the max-abs divergence per layer;
- :func:`first_divergence` names the first layer over the tolerance;
- :func:`compare_dump_with_hf` makes the same comparison from a
  ``DebugDumper`` tree on disk (``fwd_step_N/layers.i.output/shard_k.npy``).

The HF model is any ``torch.nn.Module`` the caller built (``transformers``
is not imported here). The prompt forward's last position is what an
incremental decode step computes for that token, so agreement layer by
layer here is agreement of the decode step.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.specs import ModelSpec


def hf_layer_traces(model, tokens: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-block outputs of an HF model through forward hooks:
    ``{"layers.<i>.output": [B, T, D], "lm_head.output": [B, T, V]}``."""
    blocks = next((mod for _, mod in model.named_modules()
                   if isinstance(mod, torch.nn.ModuleList) and len(mod) > 0
                   and any(True for _ in mod[0].parameters())), None)
    if blocks is None:
        raise ValueError("no decoder block list found")
    traces: Dict[str, np.ndarray] = {}
    hooks = []
    for i, blk in enumerate(blocks):
        def hook(_mod, _inp, out, i=i):
            h = out[0] if isinstance(out, tuple) else out
            traces[f"layers.{i}.output"] = h.detach().float().numpy()

        hooks.append(blk.register_forward_hook(hook))
    try:
        with torch.no_grad():
            out = model(input_ids=torch.tensor(np.asarray(tokens), dtype=torch.long))
    finally:
        for h in hooks:
            h.remove()
    traces["lm_head.output"] = out.logits.float().numpy()
    return traces


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def compare_with_hf(spec: ModelSpec, params, hf_model,
                    tokens: np.ndarray) -> List[Tuple[str, float]]:
    """Max-abs divergence of our forward from the HF hooks, per layer then
    at the logits: ``[("layers.0.output", diff), ..., ("lm_head.output",
    diff)]``, the input of :func:`first_divergence`."""
    from flexflow_tpu_torch.utils.debug_dump import forward_with_traces

    tokens = np.asarray(tokens)
    positions = np.ascontiguousarray(np.broadcast_to(np.arange(tokens.shape[1]), tokens.shape))
    dev = params["embed_tokens"].device
    _, ours = forward_with_traces(spec, params, torch.as_tensor(tokens, device=dev),
                                  torch.as_tensor(positions, device=dev))
    theirs = hf_layer_traces(hf_model, tokens)
    names = [f"layers.{i}.output" for i in range(spec.num_layers)] + ["lm_head.output"]
    return [(n, _max_abs(ours[n].float().cpu().numpy(), theirs[n])) for n in names]


def first_divergence(report: Sequence[Tuple[str, float]], atol: float) -> Optional[str]:
    """The first entry (in depth order) whose divergence exceeds ``atol``;
    None when every layer is aligned."""
    for name, diff in report:
        if diff > atol:
            return name
    return None


def compare_dump_with_hf(dump_dir: str, hf_model, tokens: np.ndarray, *, step: int = 0,
                         shard: int = 0) -> List[Tuple[str, float]]:
    """:func:`compare_with_hf` from a ``DebugDumper`` tree on disk."""
    theirs = hf_layer_traces(hf_model, tokens)
    step_dir = os.path.join(dump_dir, f"fwd_step_{step}")
    names = sorted((n for n in os.listdir(step_dir) if re.fullmatch(r"layers\.\d+\.output", n)),
                   key=lambda n: int(n.split(".")[1]))
    return [(n, _max_abs(np.load(os.path.join(step_dir, n, f"shard_{shard}.npy")), theirs[n]))
            for n in names + ["lm_head.output"]]
