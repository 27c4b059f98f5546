"""Inference debugging: per-op tensor traces and their file dumps (port of
``flexflow_tpu/utils/debug_dump.py``).

The reference's ``--inference-debugging`` mode has every op dump its
tensors per decoding step per shard into a folder tree keyed
``fwd_step_<n>/layers.<i>.<name>/shard_<k>``; the fine-grained alignment
harness (``utils/alignment.py``) reads it back.

``forward_with_traces`` runs the decoder's own prefill forward
(``decoder.forward``, with its ``traces`` hook), so the traced run launches
the kernels an untraced one does and its logits are the same bits.
``DebugDumper`` writes the traces as ``.npy`` files in the reference's tree.
The ``--inference-debugging`` flag is parsed into
``FFConfig.inference_debugging`` and read nowhere else, as in the JAX
package.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.models import decoder
from flexflow_tpu_torch.specs import ModelSpec


def forward_with_traces(
    spec: ModelSpec,
    params,
    tokens: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T]
    *,
    lengths: Optional[torch.Tensor] = None,
    flash: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Self-attention forward capturing every layer's intermediates.

    Returns ``(logits [B, T, V] f32, traces)`` with keys like
    ``layers.3.attn_output`` (``decoder.forward``'s ``traces``)."""
    traces: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        logits, _ = decoder.forward(spec, params, tokens, positions, lengths=lengths,
                                    flash=flash, traces=traces)
    return logits, traces


def _numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class DebugDumper:
    """Writes traces in the reference's folder-tree convention (bf16 tensors
    as float32: numpy has no bf16)."""

    def __init__(self, root: str, shard: int = 0):
        self.root = root
        self.shard = shard
        self.step = 0

    def dump_step(self, traces: Dict[str, Any]) -> str:
        step_dir = os.path.join(self.root, f"fwd_step_{self.step}")
        for name, arr in traces.items():
            d = os.path.join(step_dir, name)
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"shard_{self.shard}.npy"), _numpy(arr))
        self.step += 1
        return step_dir
