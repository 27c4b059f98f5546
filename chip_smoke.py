#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``flexflow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as the check runs it
    python3 chip_smoke.py --only build,kernels --reps 5
    python3 chip_smoke.py --only card,build,spec
    python3 chip_smoke.py --only card,build,kernels,spec,mixtral
    python3 chip_smoke.py --only card,build,variants
    python3 chip_smoke.py --only card,build,mixtral
    python3 chip_smoke.py --only card,build,offload
    python3 chip_smoke.py --only card,build,lora
    python3 chip_smoke.py --only card,build,serve,openai
    python3 chip_smoke.py --only card,build,finetune,train
    python3 chip_smoke.py --only card,build,kernels --parent DIR   # beside an earlier kernel

Phases, in order; any failure exits non-zero:

1. card     — needs CUDA; prints ``nvidia-smi``'s name and power limit;
              TF32 off for float32 matmuls and convolutions.
2. build    — builds the CUDA kernels from ``flexflow_tpu_torch/csrc`` with
              nvcc (``ops/kernels/_build.py``) and prints the build time.
3. kernels  — each kernel against its plain PyTorch version at LLaMA-2-7B
              shapes, with the tolerance stated beside each check; quant-matmul
              rows (qmm_int8 and qmm_int4) must be bitwise independent of the
              row count, and qmm_int4's one-hot rows must give back the
              dequantized weight (identity probe) in every regime. wgu also runs
              at each regime's edge rows (16, 17, 128, 129, the prefill
              threshold - 1 and the threshold), and the tiled and two-pass
              prefills side by side around the threshold; each timed qmm row
              logs its regime. Times each kernel, its plain version and one
              PyTorch library call (device time: CUDA events around calls
              queued while the device waits), and computes the kernel's bound
              from this run's shapes; flash_prefill is timed at the 7B shape,
              at the served prefills' shapes (the verifier's 32 heads and
              the draft's 6 at the served prompts' lengths) and with every
              row full, SDPA-causal's own work; decode_attention at the
              7B shape, the served decode's lengths, one 4096-position
              request and the verify's tree (at LLaMA-2-7B's heads, at
              Mixtral's GQA, and the 19-slot merged tree of two drafts with
              irregular parents and padding slots; every checked node
              bitwise equal to the one-token call), each rotating through
              caches past the L2. The quant-matmul rows include INT4 at the
              merged verify's 152 rows and the Mixtral expert stacks at the
              speculative verify's 104. ``--parent DIR`` builds each of an earlier
              checkout's quant_matmul.cu, flash_prefill.cu and
              decode_attention.cu that exists beside this one and times it
              beside each of its rows; every INT8 qmm output must equal it
              bitwise, and the earlier flash_prefill and decode_attention
              are held to the same limits against the plain versions as
              this tree's.
4. variants — the quant-kernel tuning path
              (``flexflow_tpu_torch.benchmarks.tune_int4_variants.run``) at
              D=4096, F=11008, B=8, group 128: the six dequant-matmul design
              variants at each of its column widths, and qmm_int8 / qmm_int4;
              every case must pass. Then each variant at each width against
              its plain version (1% of the output's magnitude) and by its
              identity probe (one-hot rows of x return the dequantized
              weight's rows, rounded to bf16, bitwise), and the plain version
              and one PyTorch library call timed beside it.
5. crosscheck — a 2-layer decoder at full 7B width, INT8 and INT4: prefill
              and 8 decode steps through the kernels on the GPU against the
              plain versions on the CPU (same weights, same tokens). At INT8,
              ``utils/debug_dump.forward_with_traces`` on the card gives
              ``decoder.forward``'s logits bitwise (the same kernels).
6. serve    — LLaMA-2-7B INT8 (32 layers, random weights from seed 0):
              InferenceEngine + RequestManager(decode_horizon=16, pipelined)
              serve 8 requests; every request must finish and every kernel's
              launch count must rise. Every greedy decode step is a replay of
              the engine's captured CUDA graph (replays must equal the served
              steps). Then one 16-step horizon, replayed, must give the
              uncaptured body's tokens and cache bitwise from the same state.
              Prints decode tok/s, mean TTFT, peak memory, graphs captured,
              capture ms and replays beside the card's name and power limit.
7. openai   — the serving surface: the serve phase's model and manager (built
              the same way when serve is not selected) behind
              ``LLM.start_server()`` (a ``LLM`` over that manager and an
              id-level stand-in tokenizer, "17 402 9" <-> [17, 402, 9]) and
              the port's OpenAI handler on a loopback ThreadingHTTPServer.
              One sampled request (temperature 0.8, top_p 0.95, 8 tokens)
              first; then 8 client threads POST the served prompts as token
              ids to /v1/completions (greedy, 64 tokens): each answer's tokens
              must equal the serve run's, usage must count 64, every greedy
              step must be a replay (so the sampled request's slot returned to
              the replay path) and qmm_int8, decode_attention and
              flash_prefill must launch. Then the longest prompt streamed: the
              deltas must join to its completion text and end with "stop" and
              [DONE]; a 1024-token prompt and bad JSON must get 400s with the
              loop alive; the loop must join on stop_server() with no request
              left RUNNING. Prints the HTTP run's decode tok/s and mean TTFT
              beside the in-process run's, the time to the first streamed
              chunk, and the per-op profile of layer 0 (batch 1, 32 tokens).
8. spec     — token-tree speculative serving: a LLaMA-2-7B INT4 verifier
              (group 128) that block-embeds a 160M-class bf16 draft (both from
              seed 0), SpecEngine + SpecRequestManager (width 3, depth 4,
              fused, pipelined over LLM.compile's spec_horizon) serve the same
              8 requests, then the incremental INT4 run of the same verifier.
              Every request must finish, qmm_int4, flash_prefill and
              decode_attention must launch, the mean verified tokens per step
              must exceed 1, and each request's first 20 tokens must equal the
              incremental run's. Both runs serve every greedy horizon as
              replays of captured graphs (one per draft window bucket for
              the speculative engine), and one 8-iteration speculative
              horizon, replayed, must give the uncaptured iterations' outputs
              and caches bitwise from the same state. Prints both runs'
              decode tok/s, mean TTFT, peak memory, graphs, capture ms and
              replays, and the mean verified tokens per step. Then two
              drafts on the same verifier tensors and cache (data_ptr
              checked): draft A (width 3, depth 4) and draft B, draft A's
              weights plus seeded noise at 5% of each tensor's RMS (width
              1, depth 6), served by ``MultiSSMSpecManager`` in rotation
              (every iteration a replay of one engine's graph) and merged
              (19-node trees, 152 verifier rows, stepwise): each request's
              first 20 tokens equal the incremental run's, and each draft
              cache's committed rows, copied when its request retires, lie
              within 5e-2 relative L2 of a fresh prefill of the request's
              history (catch-up). Prints each mode's tok/s, TTFT, peak
              memory and verified tokens per step beside the one-draft run.
9. mixtral  — Mixtral-8x7B (the published config.json's widths through
              ``from_hf_config``: 32 layers, 8 experts top-2, GQA 32/8 heads,
              dense MoE form). First a 2-layer model at that width, INT8,
              a prefill of 4 requests and 2 decode steps through the kernels
              on the GPU against the plain versions on the CPU: the top-2
              routing of every token at every layer equal except for tokens
              whose 2nd-vs-3rd routing-probability margin lies within twice
              the observed probability error (counted and reported); logits
              within 5% of their magnitude and greedy tokens equal where
              decided, on the rows before any token whose routing flipped. Then all 32 layers in INT8 (group 128),
              random weights from seed 0 built by the streaming quantized
              init (no bf16 tree), served as in ``serve``: every request
              finishes, every greedy step is a replay, launches equal the
              predicted per-step counts (per forward one qmm_int8 call for
              wqkv, wo and each expert's 3 projections a layer, plus the
              lm_head; one decode_attention call a layer a decode step, one
              flash_prefill call a layer a prefill), and one replayed 16-step
              horizon equals the uncaptured body bitwise. Then one batched
              prefill of the same prompts with the dense and with the ragged
              MoE form, timed; their logits at each request's last prompt
              position must agree by the cross-check's rule. Then Mixtral
              as the verifier of ``SpecEngine`` on the same weight tensors
              (data_ptr checked), with the 160M-class draft (random bf16
              weights, seed 0), width 3, depth 4, fused and pipelined: each
              request's first 20 tokens equal the incremental run's, every
              iteration is a replay, one replayed horizon equals the
              uncaptured body bitwise, qmm_int8, decode_attention and
              flash_prefill launch, and the peak memory stays within 4 GiB
              of the incremental run's. Prints the init time, decode tok/s,
              mean TTFT, peak memory, graphs and replays of both runs.
10. offload — CPU offload (``InferenceEngine(offload=True)``, the layer
              stack in pinned host memory streamed through two device slots
              on a copy stream, ``models/layer_store.py``). (a) LLaMA-2-7B INT8
              (random, seed 0, the streaming init written to host memory),
              resident then offload, the serve traffic (8 requests, 64 new
              tokens, decode_horizon 16, pipelined): every token equal, K1
              (lm_head, resident) / K3 (from the staged slot), K5 and K6
              launch. (b) Mixtral-8x7B bf16 at full width, 4 layers, resident
              then offload over one host build: the batched prefill's logits
              and 16 greedy decode steps' logits bitwise equal. (c)
              Mixtral-8x7B bf16 at full width, ``OFFLOAD_LAYERS`` layers (the
              machine's host memory sets the cut), offload only: 8 requests x
              16 new tokens (horizon 1, not pipelined, so each fetch closes a
              step); prints the init and cudaHostRegister seconds, the
              host-to-device rate of one 1 GiB copy from pinned memory, the
              layer copies alone, the compute alone on the staged slots
              (a ``LayerStore`` that copies nothing), TTFT and every decode step's wall, and
              peak device memory, which must stay below 25% of the layers'
              bytes; the prefill (mean TTFT) must take less than copy-alone +
              compute-alone (the copies overlap the compute).
11. lora    — multi-adapter LoRA serving: first a 2-layer LLaMA-2-7B-width
              INT8 model with 4 adapters, a prefill of 4 requests routed
              [0, 3, -1, 1] and 8 teacher-forced decode steps through the
              kernels on the GPU against the plain versions on the CPU
              (logits within 5% of their magnitude, greedy tokens equal where
              decided); on every adapter row the LoRA logits differ from the
              GPU's no-LoRA logits by more than 10x that error, and the -1
              row's equal them bitwise. Then LLaMA-2-7B INT8 (32 layers,
              random weights from seed 0) serves the serve phase's 8 requests
              without adapters, and again with 4 adapters at rank 16, alpha
              32 on q, k, v, o, gate, up and down (HF PEFT's "all-linear"),
              bf16, A and B from seed 0, the requests routed [0, 1, 2, 3, 0,
              1, -1, -1], over the same weight tensors: every request
              finishes, every greedy step is a replay, qmm_int8,
              decode_attention and flash_prefill launch, the -1 requests'
              tokens equal the no-adapter run's, and one replayed 16-step
              horizon equals the uncaptured body bitwise. Prints both runs'
              decode tok/s, mean TTFT and peak memory, and the adapters'
              bytes and build time.
12. finetune — co-scheduled LoRA finetuning (``peft/finetune.FinetuneSession``)
              on LLaMA-2-7B INT8 (32 layers, random weights from seed 0),
              bf16, two adapter slots at rank 16, alpha 32 on wq and wv (the
              PEFT CLI's targets), A and B drawn; slot 0 serves, slot 1
              trains by SGD at lr 1e-3 on 4 seeded 256-token sequences, 16
              steps. (a) One step's slot-1 gradients through K1/K3 and
              ``QuantMatmulFn`` against the plain quant-matmul on the card:
              with f32 activations over the same carriers, every tensor
              (layer 0 included) at cosine >= 0.999 and relative L2 <=
              3e-2; with bf16 activations within 1.5x the floor set by a
              second plain version (the dequantized weight multiplied in
              bf16): two right bf16 forwards part by their roundings; 129
              qmm_int8 launches and 128 backwards a step; and 2 layers at
              f32 against the CPU (1e-3). (b) The serve prompts routed [0,
              -1, 0, -1, ...] through ``run_until_idle`` with the session
              registered: tokens equal the run without it, every greedy step
              a replay, each sequence's loss falls from the first epoch to
              the last. (c) Slot 1 served before and after training: tokens
              change; one replayed horizon on the trained slot equals the
              uncaptured body bitwise. (d) Slot 1 exported as an HF PEFT
              directory and loaded into a fresh engine's slot bitwise.
              Prints the step's forward, backward and update device times,
              the backward's dequant + matmul dx per carrier beside its
              bound, decode tok/s with and without the session, and peak
              memory.
13. train   — the Trainer at LLaMA-2-7B width cut to 2 layers (f32 params,
              gradients and Adam's m and v at 16 B a parameter; 32 layers
              would not fit 80 GB), seed 0, Adam at lr 1e-4: a B=1, T=64
              first step on the card against the CPU (loss rtol 1e-4,
              gradients within 1e-4 of each leaf's magnitude, updated
              parameters within 1e-5 wherever the gradient's sign is decided:
              Adam's first update is about lr * sign(g)), 8 steps on one
              4 x 512 batch (the loss must fall), and a save_checkpoint /
              load_checkpoint resume (in memory) giving the same next loss.
              Prints step ms, tokens/s and peak memory. TF32 stays off.
14. profile — (only with ``--profile``) one 16-step decode horizon (replayed,
              then uncaptured) and one batched prefill of the served model,
              one 8-iteration speculative horizon of the spec phase
              (replayed, then uncaptured), the mixtral phase's decode
              horizon and prefill, and the lora phase's decode horizon with
              and without adapters (replayed), under ``torch.profiler``: host
              dispatch time, wall time, device busy share and the device
              time of the top 12 kernels and of every kernel of the port
              below them; for LoRA also the adapters' device time (the busy
              time the adapters add) and the kernels that grew most.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import sys
import tempfile
import time

# the H100's memory rate and L2 size are tune_quant_kernel's PEAK and L2_BYTES
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PROMPT_LENS = (600, 400, 256, 128, 100, 64, 32, 17)  # the served runs' prompts
PORT_KERNELS = ("qmm_", "decode_attention", "flash_prefill")  # in the kernels' symbol names
PHASES = ("card", "build", "kernels", "variants", "crosscheck", "serve", "openai", "spec",
          "mixtral", "offload", "lora", "finetune", "train", "profile")
DEFAULT_PHASES = PHASES[:-1]

LLAMA2_7B = dict(
    arch="LlamaForCausalLM", vocab_size=32000, hidden_size=4096, num_layers=32,
    num_heads=32, num_kv_heads=32, head_dim=128, intermediate_size=11008,
    max_position_embeddings=4096, norm_eps=1e-5, rope_theta=10000.0,
    bos_token_id=1, eos_token_id=None,
)
# the published config.json of mistralai/Mixtral-8x7B-v0.1 (the fields the
# spec reads); random weights, so no end-of-sequence token stops a request
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"], "vocab_size": 32000, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_local_experts": 8, "num_experts_per_tok": 2,
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-5, "rope_theta": 1e6,
    "sliding_window": None, "tie_word_embeddings": False, "bos_token_id": 1,
    "eos_token_id": None,
}


# the lora phase's adapters: HF PEFT's target_modules="all-linear" for a LLaMA
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
LORA_IDS = [0, 1, 2, 3, 0, 1, -1, -1]  # the served requests' adapters (-1: none)
LORA_B_STD = 0.02  # B's draw: a delta about a sixth of a projection's output

# the finetune phase: the PEFT CLI's adapters (wq, wv; two slots, slot 0
# serves and slot 1 trains) at rank 16, alpha 32, and its SGD learning rate
FT_TARGETS = ("q_proj", "v_proj")
FT_IDS = [0, -1, 0, -1, 0, -1, 0, -1]  # the co-scheduled run's requests
FT_LR = 1e-3
FT_SEQS, FT_LEN, FT_STEPS = 4, 256, 16  # 4 sequences of 256 tokens, 16 SGD steps
# the train phase: LLaMA-2-7B width at 2 layers, f32, Adam, one fixed batch
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS, TRAIN_LR = 2, 4, 512, 8, 1e-4


class PhaseError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time in ms of ``fn()`` over ``reps`` launches (CUDA events,
    ``tune_quant_kernel.op_time``)."""
    import torch

    from flexflow_tpu_torch.benchmarks.tune_quant_kernel import op_time

    return op_time(lambda _: fn(), [None], reps, torch.device("cuda"), warmup) * 1e3


def attn_within(got, want, pv_abs, p_rel: float):
    """Per-element limit of a bf16 attention output against its plain version:
    one output rounding (at most 2^-7 of |want|) plus ``p_rel`` of the row's
    sum p*|v| (``pv_abs``, the plain version on |v|), which bounds the error of
    the probabilities in P.V. Returns (max |err|, max err/limit)."""
    import torch

    err = (got.float() - want.float()).abs()
    lim = 2.0 ** -7 * want.float().abs() + p_rel * pv_abs.float()
    # rows past their length are zeros on both sides: limit 0, error 0
    ratio = torch.where(err == 0, 0.0, err / lim)
    return err.max().item(), ratio.max().item()


def bound(nbytes: float, flops: float, peak_flops: float):
    from flexflow_tpu_torch.benchmarks.tune_quant_kernel import PEAK

    t_bytes = nbytes / PEAK * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

# the dequant-matmul design variants (ops/kernels/qmm_variants.py) and the
# lines of their TPU kernel bodies
VARIANT_LINES = {"i8_group": 40, "i4_floor": 52, "i4_3dot": 84, "i4_and": 122,
                 "i4_and_bigdot": 159, "i4_and_2dot": 184}
VARIANTS = tuple(VARIANT_LINES)
REPLACES = {
    "qmm_int8": "flexflow_tpu/ops/pallas/quant_matmul.py:46 (_int8_kernel) and :181 "
                "(_int8_kernel_idx), calls :163 / :304",
    "qmm_int4": "flexflow_tpu/ops/pallas/quant_matmul.py:58 (_int4_kernel) and :192 "
                "(_int4_kernel_idx), calls :163 / :304",
    "decode_attention": "flexflow_tpu/ops/pallas/decode_attention.py:54 (kernel), call :106",
    "flash_prefill": "flexflow_tpu/ops/pallas/flash_prefill.py:34 (_kernel), call :139",
    **{name: f"benchmarks/tune_int4_variants.py:{line} (_{name}_kernel), call :227 (_call :211)"
       for name, line in VARIANT_LINES.items()},
}
SOURCES = {
    "qmm_int8": "flexflow_tpu_torch/csrc/quant_matmul.cu",
    "qmm_int4": "flexflow_tpu_torch/csrc/quant_matmul.cu",
    "decode_attention": "flexflow_tpu_torch/csrc/decode_attention.cu",
    "flash_prefill": "flexflow_tpu_torch/csrc/flash_prefill.cu",
    **{name: "flexflow_tpu_torch/csrc/qmm_variants.cu" for name in VARIANTS},
}


def _qmm(qm, qa, x, layer=None, out_dtype=None):
    """The kernel on carrier ``qa`` (layer ``layer`` of a stacked one)."""
    kw = dict(group_size=qa.group_size, n_out=qa.d_rest, layer=layer,
              out_dtype=out_dtype or x.dtype)
    if qa.bits == 8:
        return qm.qmm_int8(x, qa.q, qa.scale, **kw)
    return qm.qmm_int4(x, qa.q, qa.scale, qa.offset, **kw)


def _qmm_plain(qm, qa, x, layer=None, out_dtype=None):
    """The kernel's plain PyTorch version on the same carrier."""
    pick = (lambda t: t[layer]) if layer is not None else (lambda t: t)
    od = out_dtype or x.dtype
    if qa.bits == 8:
        return qm.qmm_int8_plain(x, pick(qa.q), pick(qa.scale), qa.group_size, qa.d_rest, od)
    return qm.qmm_int4_plain(x, pick(qa.q), pick(qa.scale), pick(qa.offset), qa.group_size,
                             qa.d_rest, od)


def _weight_bytes(bits: int, d: int, f: int, g: int) -> int:
    """Bytes of one carrier at its n_out = f columns: packed weights plus the
    f32 scale (and, for INT4, offset) tables."""
    return (d * f if bits == 8 else d * f // 2) + (1 if bits == 8 else 2) * (d // g) * f * 4


def build_parent(root: str) -> dict:
    """Build each of an earlier checkout's (``root``) ``quant_matmul.cu``,
    ``flash_prefill.cu`` and ``decode_attention.cu`` (under
    ``flexflow_tpu_torch/csrc``) that exists into a library of its own, one
    nvcc each, started together, and load it beside this one. Returns
    {"quant_matmul": handle, ...} for the sources found. The earlier
    quant-matmul's entry points take no scratch pointer: ``ff_qmm_int8(x, q,
    scale, out, M, D, Fp, n_out, g, layer, x_bf16, out_f32, stream)`` and
    ``ff_qmm_int4`` with ``offset`` after ``scale``; ``ff_flash_prefill`` has
    this tree's signature; the earlier ``ff_decode_attention`` takes no
    workspace or chunk: ``(q, k_cache, v_cache, k_new, v_new, lens, idx, nx,
    self, out, B, NT, H, KH, S, D, scale, is_bf16, stream)``."""
    import ctypes
    import hashlib
    import subprocess
    from pathlib import Path

    from flexflow_tpu_torch.ops.kernels import _build

    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    entries = {
        "quant_matmul": {"ff_qmm_int8": [P] * 4 + [I] * 5 + [L, I, I, P],
                         "ff_qmm_int4": [P] * 5 + [I] * 5 + [L, I, I, P]},
        "flash_prefill": {"ff_flash_prefill": _build.SIGNATURES["ff_flash_prefill"]},
        "decode_attention": {"ff_decode_attention": [P] * 10 + [I] * 6 + [F, I, P]},
    }
    builds = {}
    for name in entries:
        src = Path(root) / "flexflow_tpu_torch" / "csrc" / f"{name}.cu"
        if not src.exists():
            continue
        out = _build.BUILD_ROOT / f"parent-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}"
        out.mkdir(parents=True, exist_ok=True)
        lib = out / f"lib{name}_parent.so"
        proc = None if lib.exists() else subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(src), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        builds[name] = (src, lib, proc)
    require(bool(builds), f"{root} holds none of flexflow_tpu_torch/csrc/{{"
                          f"{','.join(entries)}}}.cu")
    handles = {}
    for name, (src, lib, proc) in builds.items():
        if proc is not None:
            log_text, _ = proc.communicate()
            require(proc.returncode == 0, f"building {src} failed:\n{log_text}")
        handle = ctypes.CDLL(str(lib))
        for fn, argtypes in entries[name].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        handles[name] = handle
    return handles


def _qmm_parent(plib, qa, x, layer=None, out_dtype=None):
    """The earlier kernel (``build_parent``) on carrier ``qa``."""
    import torch

    from flexflow_tpu_torch.ops.kernels import _build

    od = out_dtype or x.dtype
    out = torch.empty((x.shape[0], qa.d_rest), dtype=od, device=x.device)
    tables = [qa.scale] + ([qa.offset] if qa.bits == 4 else [])
    fn = plib.ff_qmm_int8 if qa.bits == 8 else plib.ff_qmm_int4
    err = fn(x.data_ptr(), qa.q.data_ptr(), *[t.data_ptr() for t in tables], out.data_ptr(),
             x.shape[0], x.shape[1], qa.q.shape[-1], qa.d_rest, qa.group_size, int(layer or 0),
             int(x.dtype == torch.bfloat16), int(od == torch.float32),
             _build.stream_ptr(x.device))
    _build.check(err, "earlier qmm")
    return out


def _flash_parent(plib, q, k, v, lens):
    """The earlier flash-prefill kernel (``build_parent``) on q [B, S, H, D]
    and k/v [B, S, KH, D]."""
    import torch

    from flexflow_tpu_torch.ops.kernels import _build

    out = torch.empty_like(q)
    b, s, h, d = q.shape
    err = plib.ff_flash_prefill(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                                out.data_ptr(), b, s, h, k.shape[2], d, 1.0 / math.sqrt(d),
                                int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(err, "earlier flash_prefill")
    return out


def threshold_sweep(qm, qa, d: int, n_layers: int, gen, kname: str) -> None:
    """The fused 128x128 tiling against the two-pass prefill on one carrier
    at row counts around the threshold (same bits: checked), 5 launches
    each, the layers rotating."""
    import torch

    thr = qm.PREFILL_ROWS
    it = iter(range(10 ** 9))
    try:
        for m in (129, 192, 256, 512, 1024):
            x = torch.randn((m, d), generator=gen, device="cuda").to(torch.bfloat16)
            t = {}
            outs = {}
            for path, rows_from in (("tiled", 10 ** 9), ("two-pass", 0)):
                qm.PREFILL_ROWS = rows_from
                outs[path] = _qmm(qm, qa, x, 0)
                t[path] = time_ms(lambda: _qmm(qm, qa, x, next(it) % n_layers), 5)
            require(torch.equal(outs["tiled"], outs["two-pass"]),
                    f"{kname}: tiled and two-pass differ at m={m}")
            log(f"  {kname} threshold sweep m={m}: tiled {t['tiled']:.4f} ms, two-pass "
                f"{t['two-pass']:.4f} ms (bitwise equal)")
    finally:
        qm.PREFILL_ROWS = thr


def qmm_phase(bits: int, reps: int, records: list, parent=None) -> None:
    """One quant-matmul kernel (``qmm_int8`` or ``qmm_int4``) at LLaMA-2-7B's
    fused carriers and the lm_head: against its plain version, rows bitwise
    independent of the row count, (INT4) the identity probe, and timed with
    the weights rotating past L2; wgu also at each regime's edge rows, and
    the tiled and two-pass prefill side by side around the threshold. With
    ``parent`` (an earlier kernel from ``build_parent``) each timed row also
    times it, and INT8 outputs must equal its outputs bitwise."""
    import torch

    from flexflow_tpu_torch.benchmarks.tune_quant_kernel import n_copies
    from flexflow_tpu_torch.ops.kernels import quant_matmul as qm
    from flexflow_tpu_torch.quant.weight_only import dequantize, quantize

    kname = f"qmm_int{bits}"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(bits)
    thr = qm.PREFILL_ROWS
    # rows: one decode slot, 8 decode slots, 8 slots x the 13-token tree of
    # width 3 and depth 4, and a 8192-row prefill; wgu also at each regime's
    # edges (16 | 17, 128 | 129, the prefill threshold - 1 | threshold)
    rows = (1, 8, 104, 8192)
    if bits == 8:  # and a finetune step's 256 rows (one 256-token sequence)
        rows = (1, 8, 104, FT_LEN, 8192)
    else:  # and the verify of two drafts' merged trees: 8 slots x 19 nodes
        rows = (1, 8, 104, 152, 8192)
    edges = (16, 17, 128, 129, thr - 1, thr)
    # (name, contraction shape, out width, group size, rows) of LLaMA-2-7B's
    # fused carriers; INT8's wgu again at group 64 (quantization_group_size=64),
    # whose groups are shorter than the decode tiling's 128-deep chunk
    shapes = [("wqkv", (4096,), 3 * 4096, 128, rows),
              ("wo", (32, 128), 4096, 128, rows),
              ("wgu", (4096,), 2 * 11008, 128, tuple(sorted(rows + edges))),
              ("wd", (11008,), 4096, 128, rows)]
    if bits == 8:
        shapes.append(("wgu", (4096,), 2 * 11008, 64, (8, 8192)))
        # Mixtral-8x7B's expert projections (wg / wu, and wd) at a decode
        # step's 8 rows, a speculative verify's 8 x 13 (the dense form runs
        # every expert on every row), a ragged expert group of the served
        # prefill (its 1597 valid rows x top-2 / 8 experts, ~400), a group
        # of the full 8 x 1024 bucket (2048) and the dense form's prefill (8192)
        moe_rows = (8, 104, 400, 2048, 8192)
        shapes += [("expert wg|wu", (4096,), 14336, 128, moe_rows),
                   ("expert wd", (14336,), 4096, 128, moe_rows)]
    log(f"  prefill threshold {thr} rows: from it a bf16 call dequantizes into a [D, Fp] bf16 "
        f"scratch (peak {4096 * 32256 * 2} bytes, the lm_head's 4096 x 32256 carrier)")

    def check(name, qa, x, layer, out_dtype, rel):
        """Kernel against plain on x; rows 0 and m-1 bitwise equal to 1-row
        calls; INT8 bitwise equal to the earlier kernel where one is loaded.
        Returns (max|err|, output magnitude)."""
        got = _qmm(qm, qa, x, layer, out_dtype)
        want = _qmm_plain(qm, qa, x, layer, out_dtype)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        require(bool(torch.isfinite(got).all()) and err <= rel * scale,
                f"{kname} {name} m={x.shape[0]}: max|err| {err} > {rel} * {scale}")
        for r in sorted({0, x.shape[0] - 1}):
            one = _qmm(qm, qa, x[r:r + 1].contiguous(), layer, out_dtype)
            require(torch.equal(one[0], got[r]),
                    f"{kname} {name}: row {r} of a {x.shape[0]}-row call differs from a 1-row call")
        if parent is not None:
            old = _qmm_parent(parent, qa, x, layer, out_dtype)
            diff = (old.float() - got.float()).abs().max().item()
            if bits == 8:
                require(torch.equal(old, got), f"{kname} {name} m={x.shape[0]}: differs from the "
                                               f"earlier kernel by up to {diff}")
            log(f"  {kname} {name} m={x.shape[0]}: max |new - earlier kernel| {diff:.3g}")
        return err, scale

    def identity_probe(label, qa, m):
        """INT4 identity probe through the regime of an m-row call: one-hot
        rows of x (both half-planes) padded with zero rows up to m give back
        the dequantized weight's rows bitwise, f32 and rounded to bf16."""
        d = qa.q.shape[-2] * 2
        w1 = qm.int4_weight(qa.q[1], qa.scale[1], qa.offset[1], qa.group_size)[:, :qa.d_rest]
        idx = [0, d // 2 - 1, d // 2, d - 1]
        for dt in ((torch.float32, torch.bfloat16) if m == len(idx) else (torch.bfloat16,)):
            eye = torch.zeros((max(m, len(idx)), d), device=dev, dtype=dt)
            eye[torch.arange(len(idx)), idx] = 1
            require(torch.equal(_qmm(qm, qa, eye, 1)[:len(idx)], w1[idx].to(dt)),
                    f"{kname} {label} m={m}: identity probe ({dt}) differs from the weight")

    def timed(name, qa, x, n_layers, w_lib, out_dtype, err, tol):
        m, d = x.shape
        f = qa.d_rest
        stacked = n_layers is not None
        it = iter(range(10 ** 9))
        pick = (lambda: next(it) % n_layers) if stacked else (lambda: None)
        ms = time_ms(lambda: _qmm(qm, qa, x, pick(), out_dtype), reps)
        plain_ms = time_ms(lambda: _qmm_plain(qm, qa, x, pick(), out_dtype), max(2, reps // 4),
                           warmup=1)
        lib_ms = time_ms(lambda: torch.matmul(x, w_lib[next(it) % len(w_lib)]), reps)
        out_bytes = m * f * (4 if out_dtype == torch.float32 else 2)
        nbytes = x.numel() * 2 + _weight_bytes(bits, d, f, qa.group_size) + out_bytes
        b_ms, b_by = bound(nbytes, 2.0 * m * d * f, PEAK_BF16_FLOPS)
        records.append(dict(name=f"{kname}[{name} m={m}]", kernel=kname, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        earlier = ""
        if parent is not None:  # the earlier kernel, timed in this same run
            old_ms = time_ms(lambda: _qmm_parent(parent, qa, x, pick(), out_dtype), reps)
            earlier = f" earlier {old_ms:.4f} ms"
        log(f"  {kname} {name} m={m:5d} [{qm.regime(m, d, qa.q.shape[-1], bits)}]: err {err:.3g} "
            f"(tol {tol:.3g}) kernel {ms:.4f} ms{earlier} plain {plain_ms:.4f} ms "
            f"cuBLAS-bf16 {lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})")

    for name, cshape, f, group, mrows in shapes:
        d = math.prod(cshape)
        # enough stacked layers that the rotating weight stream exceeds L2
        n_layers = n_copies(_weight_bytes(bits, d, f, group), dev)
        w = torch.randn((n_layers, *cshape, f), generator=gen, device=dev) * (2.0 / (d + f)) ** 0.5
        qa = quantize(w, bits, group, batch_dims=1, contract_dims=len(cshape))
        require(qa.group_size == group, f"{name}: group {qa.group_size} != {group}")
        del w
        w_lib = [dequantize(type(qa)(qa.q[i], qa.scale[i],
                                     None if qa.offset is None else qa.offset[i], bits,
                                     qa.group_size, qa.shape, 1, qa.contract_dims,
                                     torch.bfloat16, qa.rest_pad)).reshape(d, f).contiguous()
                 for i in range(n_layers)]
        label = f"{name} {d}x{f} g={group}"
        # float32 activations (--full-precision) take the FMA kernel:
        # summation order only -> 1e-5 of the output's magnitude
        x32 = torch.randn((8, d), generator=gen, device=dev)
        err32, _ = check(label + " f32", qa, x32, 1, torch.float32, 1e-5)
        probe = ""
        if bits == 4:
            probe_rows = sorted({4, *mrows} - {8192})  # each regime (8192 takes the threshold's)
            for m in probe_rows:
                identity_probe(label, qa, m)
            probe = f"; identity probe bitwise (f32, bf16) at m = {probe_rows}"
        log(f"  {kname} {label} f32 x, m=8: err {err32:.3g}{probe}")
        for m in mrows:
            x = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
            # tolerance: 1% of the output's magnitude - the two sum the same
            # bf16 products in f32 in different orders, then round to bf16
            err, scale = check(label, qa, x, 0, torch.bfloat16, 1e-2)
            timed(label, qa, x, n_layers, w_lib, torch.bfloat16, err, 1e-2 * scale)
        if name == "wgu" and group == 128:
            threshold_sweep(qm, qa, d, n_layers, gen, kname)
        del w_lib, qa
        torch.cuda.empty_cache()

    # shapes no LLaMA carrier has: D and F not multiples of 8 or 16 (plain
    # loads fill the ring), an odd group, a stacked layer at an unaligned
    # offset; both tilings
    d, fp, n_out, g = (1001, 300, 290, 7) if bits == 8 else (1002, 300, 290, 3)
    qa = quantize(torch.randn((2, d, fp), generator=gen, device=dev), bits, g, batch_dims=1)
    require(qa.group_size == g, f"{kname} odd shape: group {qa.group_size} != {g}")
    qa = dataclasses.replace(qa, shape=(2, d, n_out))  # n_out < the carrier's width
    for m in (7, 40):
        x = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
        err, scale = check(f"D={d} F={n_out} g={g}", qa, x, 1, torch.bfloat16, 1e-2)
        log(f"  {kname} D={d} F={n_out} g={g} m={m}: err {err:.3g} (tol {1e-2 * scale:.3g}); "
            f"rows bitwise equal to 1-row calls")

    # lm_head: 4096 -> 32000 (carrier padded to 32256), f32 logits
    d, f = 4096, 32000
    w = torch.randn((d, f), generator=gen, device=dev) * (2.0 / (d + f)) ** 0.5
    qa = quantize(w, bits, 128)
    require(qa.q.shape[-1] == 32256, f"lm_head carrier width {qa.q.shape[-1]} != 32256")
    w_lib = [dequantize(qa).to(torch.bfloat16)]
    del w
    for m in rows:
        x = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
        # f32 out: only the summation order differs (4096 terms)
        err, scale = check(f"lm_head {d}x{f} f32-out", qa, x, None, torch.float32, 1e-4)
        timed(f"lm_head {d}x{f} f32-out", qa, x, None, w_lib, torch.float32, err, 1e-4 * scale)
    del w_lib, qa
    torch.cuda.empty_cache()


def _decode_parent(plib, q, kc, vc, kn, vn, lens, index=None):
    """The earlier decode-attention kernel (``build_parent``): the one-token
    form on q [B, H, D], or the tree form on q [B, T, H, D] with ``index``
    (``tree_index``)."""
    import torch

    from flexflow_tpu_torch.ops.kernels import _build

    out = torch.empty_like(q)
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    nt = q.shape[1] if q.dim() == 4 else 1
    ptrs = [x.data_ptr() for x in index] if index is not None else [None] * 3
    err = plib.ff_decode_attention(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        lens.data_ptr(), *ptrs, out.data_ptr(), b, nt, h, kc.shape[1], kc.shape[2], d,
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(err, "earlier decode_attention")
    return out


def _cache_copies(kc, vc):
    """(k, v) cache pairs whose rotation streams past 3x the L2: ``(kc, vc)``
    and clones of it."""
    import torch

    from flexflow_tpu_torch.benchmarks.tune_quant_kernel import n_copies

    n = n_copies(2 * kc.numel() * kc.element_size(), torch.device("cuda"))
    return [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(n - 1)]


def decode_attention_phase(reps: int, records: list, parent=None) -> None:
    """K5 against its plain version in both forms (and, with ``parent``, the
    earlier kernel against the same limit), at LLaMA-2-7B heads, GQA, MQA,
    f32 and lengths at the chunk's edges; each tree node checked bitwise
    against the one-token call after its ancestors were committed. Timed at
    the 7B shape, the served decode's lengths (LLaMA-2-7B's heads and
    Mixtral-8x7B's GQA), one long request and the speculative verify's
    tree, each rotating through caches past the L2."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    c = da.CHUNK
    # (label, B, H, KH, S, D, dtype, lens, timed): LLaMA-2-7B MHA decode at
    # lengths 1024..0, at the served decode's lengths (the served prompts
    # plus ~32 generated tokens), Mixtral-8x7B's GQA (32 query heads on 8
    # KV heads) at the same lengths, and one 4096-position request; GQA,
    # MQA, f32, and lengths at the chunk's edges at D = 256 with groups of 16
    served = [632, 432, 288, 160, 132, 96, 64, 49]
    cases = [
        ("", 8, 32, 32, 1024, 128, bf16, [1024, 1000, 777, 600, 512, 300, 100, 0], True),
        (" serve", 8, 32, 32, 1024, 128, bf16, served, True),
        (" serve", 8, 32, 8, 1024, 128, bf16, served, True),
        (" long", 1, 32, 32, 4096, 128, bf16, [4096], True),
        ("", 8, 32, 32, 1024, 128, f32, [1024, 1000, 777, 600, 512, 300, 100, 0], False),
        ("", 4, 32, 8, 512, 128, bf16, [512, 64, 1, 300], False),
        ("", 4, 16, 1, 512, 64, bf16, [500, 0, 17, 512], False),
        (" edges", 5, 64, 4, 200, 256, bf16, [c - 1, c, c + 1, 0, 1], False),
    ]
    tol_bf16 = "2^-7|want| + 2^-12 sum p|v|"

    def within(got, want, pv):
        if got.dtype == bf16:
            # f32 softmax and P.V (fast exp, summation order): 2^-12 of
            # sum p|v|, far above their error, plus the output rounding
            return attn_within(got, want, pv, 2.0 ** -12)
        err = (got - want).abs().max().item()  # fast exp and summation order only
        return err, err / 1e-4

    def held(what, fns, want, pv):
        """Each (who, fn) output against ``want``; returns {who: (err, ratio)}."""
        errs = {}
        for who, fn in fns:
            got = fn()
            require(bool(torch.isfinite(got).all()), f"{what}: {who} output not finite")
            errs[who] = within(got, want, pv)
            require(errs[who][1] <= 1, f"{what}: {who} max|err| {errs[who][0]}, "
                                       f"{errs[who][1]:.3g} x the limit")
        return errs

    def report(what, errs, tol, extra=""):
        err, ratio = errs["kernel"]
        earlier = (f" [earlier kernel {errs['earlier kernel'][0]:.3g}]"
                   if "earlier kernel" in errs else "")
        log(f"  {what}: err {err:.3g} ({ratio:.3g} x the limit {tol}){earlier}{extra}")

    def timed(name, fns, plain, lib, nbytes, flops, err):
        ms = time_ms(fns[0][1], reps)
        earlier = ""
        if len(fns) > 1:
            earlier = f" [earlier kernel {time_ms(fns[1][1], reps):.4f} ms]"
        plain_ms = time_ms(plain, max(2, reps // 4), 1)
        lib_ms = time_ms(lib, reps)
        b_ms, b_by = bound(nbytes, flops, PEAK_F32_FLOPS)
        records.append(dict(name=f"decode_attention[{name}]", kernel="decode_attention",
                            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms))
        log(f"    kernel {ms:.4f} ms{earlier} plain {plain_ms:.4f} ms SDPA {lib_ms:.4f} ms "
            f"({ms / lib_ms:.2f}x) bound {b_ms:.4f} ms ({b_by})")

    for label, b, h, kh, s, d, dt, lens_l, is_timed in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)

        q, kc, vc = rnd(b, h, d), rnd(b, kh, s, d), rnd(b, kh, s, d)
        ks, vs = rnd(b, kh, d), rnd(b, kh, d)
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        want = da.decode_attention_plain(q, kc, vc, ks, vs, lens)
        pv = None
        if dt == bf16:
            pv = da.decode_attention_plain(q.float(), kc.float(), vc.float().abs(),
                                           ks.float(), vs.float().abs(), lens)
        caches = _cache_copies(kc, vc) if is_timed else [(kc, vc)]
        it = iter(range(10 ** 9))

        def nxt():
            return caches[next(it) % len(caches)]

        fns = [("kernel", lambda: da.decode_attention(q, *nxt(), ks, vs, lens))]
        if parent is not None:
            fns.append(("earlier kernel",
                        lambda: _decode_parent(parent, q, *nxt(), ks, vs, lens)))
        what = f"decode_attention{label} B={b} H={h} KH={kh} S={s} D={d} {str(dt)[6:]}"
        errs = held(what, fns, want, pv)
        report(what, errs, tol_bf16 if dt == bf16 else "1e-4")
        del want, pv
        if not is_timed:
            continue
        # yardstick: SDPA over [cache | self] with the length mask
        alls = [(torch.cat([k, ks[:, :, None]], dim=2), torch.cat([v, vs[:, :, None]], dim=2))
                for k, v in caches]
        pos = torch.arange(s + 1, device=dev)
        mask = ((pos[None] < lens[:, None]) | (pos[None] == s))[:, None, None, :]
        q4 = q[:, :, None]
        tot = int(sum(min(max(x, 0), s) for x in lens_l))
        nbytes = (2 * tot * kh * d + 2 * q.numel() + 2 * ks.numel()) * q.element_size() + 4 * b
        timed(f"B={b} H={h} KH={kh} S={s} D={d} bf16" + (f" lens={label.strip()}" if label else ""),
              fns, lambda: da.decode_attention_plain(q, *nxt(), ks, vs, lens),
              lambda: F.scaled_dot_product_attention(q4, *alls[next(it) % len(alls)],
                                                     attn_mask=mask, enable_gqa=h != kh),
              nbytes, 4.0 * h * d * (tot + b), errs["kernel"][0])
        del caches, alls
        torch.cuda.empty_cache()

    # the tree form: the speculative verify's 8 slots x the 13-node tree of
    # width 3 and depth 4 (random parents) at LLaMA-2-7B's heads and at
    # Mixtral-8x7B's GQA, and the merged tree of two drafts (3 x 4 and 1 x 6,
    # tokens from a 3-token vocabulary so that they share prefixes: 19 slots,
    # irregular parents, padding slots that attend only themselves)
    lens_l = list(PROMPT_LENS)
    tree_cases = [("", 32, 32, _beam_trees(6, 8, 3, 4)), (" GQA", 32, 8, _beam_trees(6, 8, 3, 4))]
    merged = _merged_trees(7, 8, [(3, 4), (1, 6)])
    tree_cases.append((" merged", 32, 32, merged))
    for label, h, kh, parents in tree_cases:
        tree_phase_case(label, h, kh, parents, lens_l, gen, held, report, timed, tol_bf16,
                        parent)


def _beam_trees(seed: int, b: int, width: int, depth: int, vocab: int = 0):
    """[B, 1 + width x depth] parents in ``SpecEngine.draft_tree``'s layout
    (slot 1 + (d - 1) W + w; each parent a random slot of the previous
    depth), and with ``vocab`` the tokens drawn from it (root 0); numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = 1 + width * depth
    parents = np.full((b, t), -1, np.int32)
    parents[:, 1:1 + width] = 0
    for d in range(2, depth + 1):
        base, prev = 1 + (d - 1) * width, 1 + (d - 2) * width
        parents[:, base:base + width] = prev + rng.integers(0, width, (b, width))
    if not vocab:
        return parents
    tokens = rng.integers(0, vocab, (b, t)).astype(np.int32)
    tokens[:, 0] = 0
    return tokens, parents


def _merged_trees(seed: int, b: int, shapes):
    """The parents [B, 1 + sum(W D)] of ``tree_merge.merge_batch`` over one
    draft tree of each (width, depth) in ``shapes``, tokens from a 3-token
    vocabulary (shared prefixes dedup; padding slots have parent -2)."""
    from flexflow_tpu_torch.serving.tree_merge import merge_batch

    trees = [_beam_trees(seed + i, b, w, d, vocab=3) for i, (w, d) in enumerate(shapes)]
    t = 1 + sum(w * d for w, d in shapes)
    return merge_batch(trees, t, t)[1]


def tree_phase_case(label, h, kh, parents, lens_l, gen, held, report, timed, tol_bf16,
                    parent) -> None:
    """K5's tree form on 8 slots of one tree each (``parents`` [B, T]; -1 the
    root, -2 a padding slot that attends only itself) against its plain
    version, each checked node bitwise equal to the one-token call after its
    ancestors were committed, then timed rotating through caches past L2."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    s, d = 1024, 128
    parents = torch.as_tensor(parents, dtype=torch.long)
    b, t = parents.shape
    anc = torch.eye(t, dtype=torch.bool).repeat(b, 1, 1)
    for cc in range(1, t):
        ok = parents[:, cc] >= 0
        anc[ok, cc] |= anc[ok.nonzero()[:, 0], parents[ok, cc]]
    anc = anc.to(dev)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    pads = int((parents == -2).sum())

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q, kn, vn = rnd(b, t, h, d), rnd(b, t, kh, d), rnd(b, t, kh, d)
    kc, vc = rnd(b, kh, s, d), rnd(b, kh, s, d)
    index = da.tree_index(anc)
    want = da.tree_attention_plain(q, kc, vc, kn, vn, lens, anc)
    pv = da.tree_attention_plain(q.float(), kc.float(), vc.float().abs(), kn.float(),
                                 vn.float().abs(), lens, anc)
    caches = _cache_copies(kc, vc)
    it = iter(range(10 ** 9))

    def nxt():
        return caches[next(it) % len(caches)]

    fns = [("kernel", lambda: da.tree_attention(q, *nxt(), kn, vn, lens, anc, index=index))]
    if parent is not None:
        fns.append(("earlier kernel",
                    lambda: _decode_parent(parent, q, *nxt(), kn, vn, lens, index)))
    what = f"decode_attention tree{label} B={b} T={t} H={h} KH={kh} S={s} D={d} bfloat16"
    errs = held(what, fns, want, pv)
    del want, pv
    got = da.tree_attention(q, kc, vc, kn, vn, lens, anc)
    # each node bitwise equal to the one-token call after its ancestors were
    # committed into the cache at lens, lens + 1, ... (incremental decoding):
    # every node of slots 0 and 5 (padding slots included), and two of slot 7
    nodes = [(0, cc) for cc in range(t)] + [(5, cc) for cc in range(t)] + [(7, 1), (7, t - 2)]
    for bi, cc in nodes:
        path = anc[bi, cc].nonzero()[:, 0].tolist()
        n = lens_l[bi]
        ck, cv = kc[bi:bi + 1].clone(), vc[bi:bi + 1].clone()
        for j, a in enumerate(path[:-1]):
            ck[0, :, n + j] = kn[bi, a]
            cv[0, :, n + j] = vn[bi, a]
        one = da.decode_attention(q[bi:bi + 1, cc].contiguous(), ck, cv,
                                  kn[bi:bi + 1, cc].contiguous(), vn[bi:bi + 1, cc].contiguous(),
                                  torch.tensor([n + len(path) - 1], dtype=torch.int32,
                                               device=dev))
        require(torch.equal(one[0], got[bi, cc]),
                f"tree attention{label}: slot {bi} node {cc} differs from the one-token call")
    report(what, errs, tol_bf16, f"; {len(nodes)} nodes bitwise equal to one-token calls"
                                 f"{f'; {pads} padding slots' if pads else ''}")
    # yardstick: SDPA over [cache | tree] with the joint mask
    alls = [(torch.cat([k, kn.transpose(1, 2)], dim=2), torch.cat([v, vn.transpose(1, 2)], 2))
            for k, v in caches]
    pos = torch.arange(s, device=dev)
    mask = torch.cat([(pos[None, None] < lens[:, None, None]).expand(b, t, s), anc], dim=-1)[:, None]
    qt = q.transpose(1, 2)
    # bytes: the valid cache rows once, q, the tree's K/V and the output;
    # operations: 4 per (query head, element, attended column)
    cols = sum(t * n for n in lens_l) + int(anc.sum())
    nbytes = (2 * sum(lens_l) * kh * d + 2 * q.numel() + 2 * kn.numel()) * 2 + 4 * b
    timed(f"tree{label} B={b} T={t} H={h} KH={kh} S={s} D={d} bf16", fns,
          lambda: da.tree_attention_plain(q, *nxt(), kn, vn, lens, anc),
          lambda: F.scaled_dot_product_attention(qt, *alls[next(it) % len(alls)], attn_mask=mask,
                                                 enable_gqa=h != kh),
          nbytes, 4.0 * h * d * cols, errs["kernel"][0])
    del caches, alls
    torch.cuda.empty_cache()


def flash_prefill_phase(reps: int, records: list, parent=None) -> None:
    """K6 against its plain version (and, with ``parent``, the earlier kernel
    against the same limit) at LLaMA-2-7B heads, GQA, MQA and f32; timed at
    the 7B shape, at the served prefills' shapes (the verifier's, Mixtral's
    GQA and the draft's heads at the served prompts' lengths) and with every
    row full, where SDPA-causal does the kernel's own work."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.kernels import flash_prefill as fp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    served = list(PROMPT_LENS)
    # (label, B, S, H, KH, D, dtype, lens, timed)
    cases = [
        ("", 8, 1024, 32, 32, 128, bf16, [1024, 900, 700, 512, 300, 128, 64, 17], True),
        ("", 2, 200, 32, 8, 128, bf16, [200, 77], False),  # GQA, S not a tile multiple
        ("", 2, 256, 16, 1, 64, bf16, [256, 5], False),  # MQA
        ("", 2, 300, 32, 32, 128, f32, [300, 150], False),  # --full-precision
        # the served prefills: the serve phase's 8 x 1024 bucket, the
        # mixtral phase's (GQA, 8 KV heads), and the spec phase's draft
        # (6 heads) on the same prompts
        (" serve", 8, 1024, 32, 32, 128, bf16, served, True),
        (" serve", 8, 1024, 32, 8, 128, bf16, served, True),
        (" draft", 8, 1024, 6, 6, 128, bf16, served, True),
        # every row full: SDPA-causal's work equals the kernel's
        (" full", 8, 1024, 32, 32, 128, bf16, [1024] * 8, True),
    ]
    for label, b, s, h, kh, d, dt, lens_l, timed in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)

        q, k, v = rnd(b, s, h, d), rnd(b, s, kh, d), rnd(b, s, kh, d)
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        want = fp.flash_prefill_plain(q, k, v, lens)
        if dt == bf16:
            # bf16 probabilities in P.V: each p rounds by at most 2^-9, so
            # 2^-8 of sum p|v| is twice their worst case; plus the output rounding
            pv = fp.flash_prefill_plain(q.float(), k.float(), v.float().abs(), lens)
            tol = "2^-7|want| + 2^-8 sum p|v|"

            def within(got):
                return attn_within(got, want, pv, 2.0 ** -8)
        else:  # fast exp and summation order only
            tol = "1e-4"

            def within(got):
                err = (got - want).abs().max().item()
                return err, err / 1e-4
        what = f"flash_prefill{label} B={b} S={s} H={h} KH={kh} D={d} {str(dt)[6:]}"
        kernels = [("kernel", lambda: fp.flash_prefill(q, k, v, lens))]
        if parent is not None:
            kernels.append(("earlier kernel", lambda: _flash_parent(parent, q, k, v, lens)))
        errs = {}
        for who, fn in kernels:
            got = fn()
            require(bool(torch.isfinite(got).all()), f"{what}: {who} output not finite")
            errs[who] = within(got)
            require(errs[who][1] <= 1, f"{what}: {who} max|err| {errs[who][0]}, "
                                       f"{errs[who][1]:.3g} x the limit {tol}")
        err, ratio = errs["kernel"]
        earlier = ""
        if parent is not None:
            earlier = f" [earlier kernel {errs['earlier kernel'][0]:.3g}]"
        log(f"  {what}: err {err:.3g} ({ratio:.3g} x the limit {tol}){earlier}")
        if not timed:
            continue
        ms = time_ms(kernels[0][1], reps)
        if parent is not None:
            earlier = f" [earlier kernel {time_ms(kernels[1][1], reps):.4f} ms]"
        plain_ms = time_ms(lambda: fp.flash_prefill_plain(q, k, v, lens), max(2, reps // 4), 1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                enable_gqa=h != kh), reps)
        pairs = sum(n * (n + 1) // 2 for n in lens_l)
        # the valid q/k/v rows are read (no row at or past its length is
        # loaded); every output row is written
        valid = sum(min(n, s) for n in lens_l)
        nbytes = (valid * (h + 2 * kh) * d + b * s * h * d) * 2 + 4 * b
        b_ms, b_by = bound(nbytes, 4.0 * h * d * pairs, PEAK_BF16_FLOPS)
        name = f"B={b} S={s} H={h} KH={kh} D={d} bf16" + (f" lens={label.strip()}" if label else "")
        records.append(dict(name=f"flash_prefill[{name}]", kernel="flash_prefill",
                            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms))
        log(f"    kernel {ms:.4f} ms{earlier} plain {plain_ms:.4f} ms SDPA-causal {lib_ms:.4f} ms "
            f"({ms / lib_ms:.2f}x) bound {b_ms:.4f} ms ({b_by})")
        torch.cuda.empty_cache()


def variants_phase(reps: int, records: list) -> dict:
    """The quant-kernel tuning path at its full shape, with the launch counts
    set to 0 just before and read just after; then, on the tuning run's own
    x and carriers, each variant at each column width against its plain
    version and by its identity probe, timed beside its plain version and
    ``torch.matmul`` on the pre-dequantized bf16 weight (both rotating past
    L2, as the tuning run's kernel times do)."""
    import torch

    from flexflow_tpu_torch.benchmarks import tune_int4_variants as tv
    from flexflow_tpu_torch.benchmarks import tune_quant_kernel as tq
    from flexflow_tpu_torch.ops.kernels import qmm_variants as qv
    from flexflow_tpu_torch.ops.kernels import quant_matmul as qm
    from flexflow_tpu_torch.quant.weight_only import dequantize

    d, f, b, g = 4096, 11008, 8, 128
    dev = torch.device("cuda")
    _launches(reset=True)
    cases, data = tv.run(d, f, b, g, device=dev, reps=reps)
    torch.cuda.synchronize()
    launches = _launches()
    failed = [r["name"] for r in cases if not r["ok"]]
    require(not failed, f"tuning cases failed: {failed}")
    for name in VARIANTS:
        require(launches[name] > 0, f"{name} was never launched by the tuning path")

    x, qa, rot = data["x"], data["qa"], data["rot"]
    weight = {8: (qa[8].q.float() * torch.repeat_interleave(qa[8].scale, g, dim=0))[:, :f],
              4: qm.int4_weight(qa[4].q, qa[4].scale, qa[4].offset, g)[:, :f]}
    idx = [0, d // 2 - 1, d // 2, d - 1]
    eye = torch.zeros((len(idx), d), device=dev, dtype=torch.bfloat16)
    eye[torch.arange(len(idx)), idx] = 1
    lib_ms, plain_ms = {}, {}
    for bits in (8, 4):
        w_lib = [dequantize(c) for c in rot[bits][:tq.n_copies(d * f * 2, dev)]]
        lib_ms[bits] = tq.op_time(lambda w: torch.matmul(x, w), w_lib, reps, dev) * 1e3
        del w_lib
    nbytes = {bits: x.numel() * 2 + _weight_bytes(bits, d, f, g) + b * f * 2 for bits in (8, 4)}
    for r in cases:
        name, cols, bits = r["variant"], r["cols"], r["bits"]
        if cols is None:
            continue
        label = f"{name} cols={cols} B={b} {d}x{f} g={g}"
        got = qv.variant(name, x, qa[bits], cols)
        want = qv.plain(name, x, qa[bits])
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        # 1% of the output's magnitude: the same products summed in another
        # order in f32, then one bf16 rounding
        require(bool(torch.isfinite(got).all()) and err <= 1e-2 * scale,
                f"{label}: max|err| {err} > 1e-2 * {scale}")
        require(torch.equal(qv.variant(name, eye, qa[bits], cols),
                            weight[bits][idx].to(torch.bfloat16)),
                f"{label}: identity probe differs from the dequantized weight")
        if name not in plain_ms:
            plain_ms[name] = tq.op_time(lambda c: qv.plain(name, x, c), rot[bits],
                                        max(2, reps // 4), dev, warmup=1) * 1e3
        b_ms, b_by = bound(nbytes[bits], 2.0 * b * d * f, PEAK_BF16_FLOPS)
        ms = r["seconds"] * 1e3
        records.append(dict(name=f"{name}[cols={cols} B={b} {d}x{f} g={g}]", kernel=name,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms[name], bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms[bits]))
        log(f"  {label}: err {err:.3g} (tol {1e-2 * scale:.3g}), identity probe bitwise; "
            f"kernel {ms:.4f} ms plain {plain_ms[name]:.4f} ms cuBLAS-bf16 {lib_ms[bits]:.4f} ms "
            f"bound {b_ms:.4f} ms ({b_by})")
    out = dict(launches=launches, cases={r["name"]: r["seconds"] * 1e3 for r in cases})
    log(f"  launches during the tuning run: {json.dumps(launches)}")
    del data, qa, rot, weight
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# model phases
# ---------------------------------------------------------------------------


def _quant_params(spec, seed: int, device, bits: int = 8):
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.quant import quantize_params

    gen = torch.Generator(device=device).manual_seed(seed)
    params = params_lib.init_params(spec, gen, torch.bfloat16, device)
    params = quantize_params(spec, params, bits=bits, group_size=128,
                             compute_dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    return params


def _traces_bitwise(spec, params, tokens, positions, lengths) -> int:
    """``utils/debug_dump.forward_with_traces`` on the card against
    ``decoder.forward`` on the same inputs: the final logits bitwise equal
    (the traced run launches the same kernels), every trace finite.
    Returns the number of traces."""
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.utils.debug_dump import forward_with_traces

    with torch.no_grad():
        want, _ = decoder.forward(spec, params, tokens, positions, lengths=lengths, flash=True)
    got, traces = forward_with_traces(spec, params, tokens, positions, lengths=lengths,
                                      flash=True)
    require(torch.equal(got, want), "forward_with_traces: logits differ from decoder.forward's")
    require(len(traces) == 5 * spec.num_layers + 2
            and all(bool(torch.isfinite(v.float()).all()) for v in traces.values()),
            f"forward_with_traces: {len(traces)} traces, or a trace not finite")
    log(f"  forward_with_traces: logits bitwise equal to decoder.forward's; {len(traces)} traces")
    return len(traces)


def crosscheck_phase(bits: int) -> dict:
    """2 layers at full 7B width, INT8 or INT4: GPU (kernels) vs CPU (plain)."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.serving.engine import _params_to
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": 2})
    gpu = decoder.fuse_qkv_params(spec, _quant_params(spec, 1, torch.device("cuda"), bits))
    cpu = _params_to(gpu, torch.device("cpu"))
    rng = np.random.default_rng(4)
    lens = np.array([20, 13], np.int32)
    t = 32
    toks = np.zeros((2, t), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(3, spec.vocab_size, n)
    s_max, steps = 64, 8
    caches, logits = {}, {}
    traced = None
    for name, dev, params in (("cuda", torch.device("cuda"), gpu), ("cpu", torch.device("cpu"), cpu)):
        cache = decoder.init_kv_cache(spec, 2, s_max, torch.bfloat16, dev)
        tk = torch.as_tensor(toks, device=dev)
        pos = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(2, t)
        ln = torch.as_tensor(lens, device=dev)
        with torch.no_grad():
            lg, (k, v) = decoder.forward(spec, params, tk, pos, lengths=ln, flash=True,
                                         return_kv=True, logits_at=ln - 1)
        if name == "cuda" and bits == 8:
            traced = _traces_bitwise(spec, params, tk, pos, ln)
        decoder.commit_kv_windows(cache.k, cache.v, k.permute(0, 1, 3, 2, 4),
                                  v.permute(0, 1, 3, 2, 4), [0, 0])
        caches[name] = cache
        logits[name] = [lg.float().cpu()]
    # decode: the GPU's greedy tokens drive both sides (teacher forcing)
    cur = logits["cuda"][0].argmax(-1)
    for i in range(steps):
        for name, dev, params in (("cuda", torch.device("cuda"), gpu), ("cpu", torch.device("cpu"), cpu)):
            with torch.no_grad():
                lg, _ = decoder.forward_cached(
                    spec, params, cur[:, None].to(dev), caches[name],
                    torch.as_tensor(lens + i, device=dev), write_start=lens + i)
            logits[name].append(lg[:, 0].float().cpu())
        cur = logits["cuda"][-1].argmax(-1)
    g = torch.stack(logits["cuda"])
    c = torch.stack(logits["cpu"])
    require(bool(torch.isfinite(g).all()) and g.shape == (steps + 1, 2, spec.vocab_size),
            f"cross-check logits not finite or shaped {tuple(g.shape)}")
    err = (g - c).abs().max().item()
    scale = c.abs().max().item()
    # bf16 activations round at different points in the kernels' and the
    # plain versions' sums: allow 5% of the logits' magnitude
    tol = 5e-2 * scale
    require(err <= tol, f"cross-check logits: max|err| {err} > {tol}")
    top2 = torch.topk(c, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = g.argmax(-1) == c.argmax(-1)
    # greedy tokens must agree wherever the CPU's top-2 margin exceeds the
    # observed logit error (closer ties are within rounding)
    decided = margin > 2 * err
    require(bool(agree[decided].all()),
            f"cross-check greedy tokens disagree at decided positions: {agree.tolist()}")
    out = dict(max_abs_err=err, tol=tol, tokens_equal=int(agree.sum()), tokens=int(agree.numel()),
               decided=int(decided.sum()), traces=traced)
    log(f"  cross-check INT{bits}: logits max|err| {err:.4g} (tol {tol:.4g}); greedy tokens equal "
        f"{out['tokens_equal']}/{out['tokens']} ({out['decided']} beyond the error margin)")
    del gpu, cpu, caches
    torch.cuda.empty_cache()
    return out


def _trace(runs, keep_all: bool = False) -> dict:
    """Each (name, fn, steps) run once to warm up, once timed on the host
    (dispatch, then wall after a sync) and once under ``torch.profiler``:
    device busy share and the device time of the top kernels (of every
    kernel, under ``kernels_ms``, with ``keep_all``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn, steps in runs:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # device-side events only (kernels, memcpy/memset): CPU ops also
        # carry their kernels' time and would count it twice
        dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and e.self_device_time_total > 0}
        busy_ms = sum(dev_us.values()) / 1e3
        ranked = sorted(dev_us.items(), key=lambda kv: -kv[1])
        # the top 12, and every kernel of the port's below them
        top = ranked[:12] + [kv for kv in ranked[12:] if any(n in kv[0] for n in PORT_KERNELS)]
        out[name] = dict(host_dispatch_ms=t_host * 1e3, wall_ms=t_wall * 1e3,
                         per_step_ms=t_wall * 1e3 / steps, device_busy_ms=busy_ms,
                         device_busy_share=busy_ms / (t_wall * 1e3),
                         top_kernels_ms={k: v / 1e3 for k, v in top})
        if keep_all:
            out[name]["kernels_ms"] = {k: v / 1e3 for k, v in dev_us.items()}
        log(f"  {name}: host dispatch {t_host * 1e3:.2f} ms, wall {t_wall * 1e3:.2f} ms "
            f"({t_wall * 1e3 / steps:.3f} ms/step), device busy {busy_ms:.2f} ms "
            f"({100 * busy_ms / (t_wall * 1e3):.1f}%)")
        for k, v in top:
            log(f"    {v / 1e3:9.3f} ms  {k[:100]}")
    return out


def profile_phase(engine, prompts) -> dict:
    """Where a served step's time goes: one decode horizon (16 steps, 8
    slots) and one batched prefill, each timed on the host and traced."""
    import numpy as np

    from flexflow_tpu_torch.ops.sampling import SamplingConfig

    b = engine.max_requests
    greedy = SamplingConfig(np.zeros(b, np.float32), np.ones(b, np.float32),
                            np.zeros(b, np.int32))
    lens = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros(b, np.int32)
    return _trace([
        ("decode_horizon_16", lambda: engine.decode_horizon_async(lens, toks, 0, greedy, 16), 16),
        ("decode_horizon_16_uncaptured",
         lambda: engine.greedy_horizon_async(lens, toks, 16, replay=False), 16),
        ("prefill_8x1024",
         lambda: engine.prefill_batch_to_slots_async(prompts, list(range(b)), 0, greedy), 1),
    ])


def spec_profile(engine, prompts) -> dict:
    """Where a speculative iteration's time goes: one horizon of 8 fused
    iterations (draft tree, tree verify, walk, two commits) on 8 slots,
    replayed and then uncaptured."""
    lens = engine._h([len(p) for p in prompts])
    roots = engine._h([1] * len(prompts))
    return _trace([
        ("spec_horizon_8", lambda: engine.fused_step_n_async(lens, roots, 8), 8),
        ("spec_horizon_8_uncaptured",
         lambda: engine.greedy_horizon_async(lens, roots, 8, replay=False), 8),
    ])


def _launches(reset: bool = False) -> dict:
    """Every kernel wrapper's launch count (set to 0 first with ``reset``)."""
    from flexflow_tpu_torch.ops.kernels import decode_attention as da
    from flexflow_tpu_torch.ops.kernels import flash_prefill as fp
    from flexflow_tpu_torch.ops.kernels import qmm_variants as qv
    from flexflow_tpu_torch.ops.kernels import quant_matmul as qm

    if reset:
        qm.LAUNCHES = qm.LAUNCHES_INT4 = da.LAUNCHES = fp.LAUNCHES = 0
        qv.LAUNCHES.update(dict.fromkeys(qv.LAUNCHES, 0))
    return {"qmm_int8": qm.LAUNCHES, "qmm_int4": qm.LAUNCHES_INT4,
            "decode_attention": da.LAUNCHES, "flash_prefill": fp.LAUNCHES, **qv.LAUNCHES}


def _prompts(vocab_size: int):
    """The served runs' 8 prompts (random tokens from seed 5)."""
    import numpy as np

    rng = np.random.default_rng(5)
    return [rng.integers(3, vocab_size, n).tolist() for n in PROMPT_LENS]


def _served(rm, prompts, max_new: int, vocab_size: int, path: str, warm=None, adapters=None,
            session=None, replayed: bool = True):
    """Warm up on one short request (through ``warm``, a scheduler on the
    same engine, or ``rm``), set the launch counts to 0, serve ``prompts``
    (request i through LoRA adapter ``adapters[i]``; default none; with a
    finetuning ``session`` registered after the warm-up, which
    ``run_until_idle`` steps between scheduling iterations and drains) and
    read the counts. Every request must finish with ``max_new`` tokens from
    the vocabulary, and (``replayed``) every step must be a replay of one of
    the manager's engines' graphs. Returns (requests, stats)."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.serving.request_manager import GenerationConfig

    (warm or rm).generate([prompts[-1]], GenerationConfig(max_new_tokens=4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _launches(reset=True)
    if session is not None:
        rm.register_finetune(session)
    # an engine that captures nothing (CPU offload) has no graphs to count
    graphs = [e.graphs for e in getattr(rm, "engines", [rm.engine]) if e.graphs is not None]
    replays0 = sum(g.replays for g in graphs)
    steps0 = rm.total_decoding_steps
    t_start = time.monotonic()
    guids = [rm.register_request(p, GenerationConfig(max_new_tokens=max_new, adapter_id=a))
             for p, a in zip(prompts, adapters or [-1] * len(prompts))]
    rm.run_until_idle()
    reqs = [rm.get_request(g) for g in guids]
    torch.cuda.synchronize()
    t_end = time.monotonic()
    launches = _launches()
    for r in reqs:
        require(r.state == "COMPLETED" and len(r.output_tokens) == max_new,
                f"{path} request {r.guid}: state {r.state}, {len(r.output_tokens)} tokens")
        require(all(0 <= t < vocab_size for t in r.output_tokens),
                f"{path} request {r.guid}: token outside the vocabulary")
    # every greedy step (an incremental step, or a speculative iteration) of
    # the run was a replay of a captured graph
    replays = sum(g.replays for g in graphs) - replays0
    require(replays == (rm.total_decoding_steps - steps0 if replayed else 0),
            f"{path}: {replays} replays for {rm.total_decoding_steps - steps0} steps")
    first = max(r.profile.first_token_time for r in reqs)
    decode_tokens = sum(len(r.output_tokens) - 1 for r in reqs)
    return reqs, dict(
        requests=len(reqs), tokens=sum(len(r.output_tokens) for r in reqs),
        decode_tok_s=decode_tokens / (t_end - first),
        mean_ttft_ms=1e3 * float(np.mean([r.profile.ttft for r in reqs])),
        wall_s=t_end - t_start, steps=rm.total_decoding_steps - steps0,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30, launches=launches,
        graphs=sum(len(g.graphs) for g in graphs), capture_ms=sum(g.capture_ms for g in graphs),
        replays=replays)


def _log_served(what: str, out: dict, card: str) -> None:
    log(f"  {what}: {out['requests']} requests, {out['tokens']} tokens in {out['wall_s']:.3f} s: "
        f"decode {out['decode_tok_s']:.1f} tok/s, mean TTFT {out['mean_ttft_ms']:.1f} ms, "
        f"{out['steps']} steps, peak memory {out['peak_mem_gib']:.2f} GiB allocated, "
        f"{out['peak_reserved_gib']:.2f} GiB reserved [{card}]")
    log(f"  {what}: {out['graphs']} CUDA graphs captured in {out['capture_ms']:.1f} ms "
        f"(warm-ups included), {out['replays']} replays in the run")
    log(f"  launches during the {what} run: {json.dumps(out['launches'])}")


def _replay_check(what: str, run, caches) -> None:
    """``run(replay)`` uncaptured, then replayed from the same state (the
    caches put back in between): its outputs and the caches it wrote must
    be bitwise equal."""
    import torch

    saved = [c.clone() for c in caches]
    want = [x.clone() for x in run(False)]
    torch.cuda.synchronize()
    want_caches = [c.clone() for c in caches]
    for c, x in zip(caches, saved):
        c.copy_(x)
    got = run(True)
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"{what}: replayed outputs differ from the uncaptured body's")
    require(all(torch.equal(c, w) for c, w in zip(caches, want_caches)),
            f"{what}: the replayed horizon's cache differs from the uncaptured body's")
    require(any(not torch.equal(c, x) for c, x in zip(caches, saved)),
            f"{what}: the horizon wrote nothing into the cache")
    log(f"  {what}: replayed outputs and cache bitwise equal to the uncaptured body's")
    del saved, want_caches
    torch.cuda.empty_cache()


def _llama_serving():
    """The served model: LLaMA-2-7B INT8 (group 128, random weights from seed
    0), 8 slots, max_seq_len 1024, decode_horizon 16, pipelined. Returns
    (spec, engine, request manager, the 8 prompts)."""
    import torch

    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    dev = torch.device("cuda")
    spec = ModelSpec(**LLAMA2_7B)
    t0 = time.perf_counter()
    params = _quant_params(spec, 0, dev)
    torch.cuda.synchronize()
    log(f"  weights: random LLaMA-2-7B INT8 in {time.perf_counter() - t0:.1f} s")
    engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                             max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev)
    del params
    return spec, engine, RequestManager(engine, decode_horizon=16, pipelined=True), \
        _prompts(spec.vocab_size)


def serve_phase(card: str, with_profile: bool, hold: dict = None) -> dict:
    """The served run; with ``hold`` the model, its manager, the prompts and
    the run's requests and stats are kept there (the openai phase serves
    them again) instead of freed."""
    import numpy as np
    import torch

    spec, engine, rm, prompts = _llama_serving()
    try:
        reqs, out = _served(rm, prompts, 64, spec.vocab_size, "serve")
        lens = np.array([len(p) for p in prompts], np.int32)
        # not the served tokens, so the horizon writes other K/V than the run did
        toks = np.array([(r.output_tokens[0] + 1) % spec.vocab_size for r in reqs], np.int32)
        _replay_check("decode horizon (16 steps, 8 slots)",
                      lambda replay: [engine.greedy_horizon_async(lens, toks, 16, replay=replay)],
                      list(engine.cache))
        if with_profile:
            log("[profile] one decode horizon and one batched prefill of the served model")
            out["profile"] = profile_phase(engine, prompts)
    finally:
        if hold is None:
            rm.close()
    for k in ("qmm_int8", "decode_attention", "flash_prefill"):
        require(out["launches"][k] > 0, f"{k} was never launched while serving")
    out["card"] = card
    _log_served("served", out, card)
    if hold is not None:
        hold.update(spec=spec, rm=rm, prompts=prompts, reqs=reqs, out=out)
    del engine, rm
    torch.cuda.empty_cache()
    return out


class IdTokenizer:
    """The openai phase's stand-in tokenizer: text of decimal ids, "17 402 9"
    <-> [17, 402, 9] (no checkpoint, so no tokenizer, is in the repository).
    The decode of a prefix is a prefix of the decode of the whole."""

    def __call__(self, text: str, return_tensors=None) -> dict:
        return {"input_ids": [int(t) for t in text.split()]}

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        return " ".join(str(int(t)) for t in ids)


def _post(port: int, body, raw: bytes = None):
    """(status, JSON body) of a POST to the loopback server's /v1/completions."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                 data=raw if raw is not None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _stream(port: int, body) -> tuple:
    """A streamed completion: (text deltas, finish reasons, the last event,
    seconds to the first non-empty delta)."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    t0, first, deltas, finishes, last = time.monotonic(), None, [], [], None
    with urllib.request.urlopen(req, timeout=600) as r:
        require(r.headers["Content-Type"].startswith("text/event-stream"),
                f"stream: content type {r.headers['Content-Type']}")
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            last = line[6:]
            if last == "[DONE]":
                continue
            choice = json.loads(last)["choices"][0]
            if choice["text"] and first is None:
                first = time.monotonic() - t0
            deltas.append(choice["text"])
            finishes.append(choice["finish_reason"])
    return deltas, finishes, last, first


def openai_phase(card: str, held: dict) -> dict:
    """The serve phase's model and manager (built here when that phase did
    not run) behind ``LLM.start_server()`` and the port's OpenAI handler on
    a loopback ``ThreadingHTTPServer``: one sampled request, then the served
    traffic from 8 client threads as token-id prompts, one streamed request
    and two bad ones. Every greedy step is a replay, each request's 64 tokens
    equal the in-process run's, and the server stops clean."""
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from flexflow_tpu_torch.inference.entrypoint import openai_server
    from flexflow_tpu_torch.serve import LLM
    from flexflow_tpu_torch.utils.profiling import per_op_profile

    if not held:
        spec, engine, rm, prompts = _llama_serving()
        reqs, base = _served(rm, prompts, 64, spec.vocab_size, "serve")
        del engine
    else:
        spec, rm, prompts, reqs, base = (held.pop(k) for k in
                                         ("spec", "rm", "prompts", "reqs", "out"))
    engine = rm.engine

    class ServedLLM(LLM):
        """The LLM API over an existing manager and tokenizer."""

        def __init__(self, rm, tokenizer):
            self.rm, self.tokenizer, self.output_file = rm, tokenizer, ""

    llm = ServedLLM(rm, IdTokenizer())
    llm.start_server()
    loop = rm._server_thread
    srv = ThreadingHTTPServer(("127.0.0.1", 0), openai_server.make_handler(llm, "llama-2-7b"))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    out = {}

    def idle():  # the loop holds no request and no horizon (read from this thread)
        t_end = time.monotonic() + 60
        while (rm._inflight_q or any(rm._slots)) and time.monotonic() < t_end:
            time.sleep(0.001)

    try:
        # 1. a sampled request first: its slot must not keep later greedy
        # horizons off the replay path once it retires
        code, body = _post(port, {"prompt": prompts[-1], "max_tokens": 8,
                                  "temperature": 0.8, "top_p": 0.95})
        require(code == 200 and body["usage"]["completion_tokens"] == 8,
                f"openai: the sampled request got {code} {body}")
        idle()
        require(not np.any(rm._temperature > 0), "openai: a retired slot kept its temperature")

        # 2. the served traffic over HTTP, one client thread a prompt
        _launches(reset=True)
        replays0, steps0 = engine.graphs.replays, rm.total_decoding_steps
        guid0 = max(rm._requests)
        answers = [None] * len(prompts)

        def client(i):
            answers[i] = _post(port, {"prompt": prompts[i], "max_tokens": 64,
                                      "temperature": 0})

        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        t_start = time.monotonic()
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        t_end = time.monotonic()
        idle()
        launches = _launches()
        replays, steps = engine.graphs.replays - replays0, rm.total_decoding_steps - steps0
        http_reqs = [r for g, r in sorted(rm._requests.items()) if g > guid0]
        for i, (code, body) in enumerate(answers):
            require(code == 200, f"openai: request {i} got {code} {body}")
            got, want = [int(t) for t in body["choices"][0]["text"].split()], reqs[i].output_tokens
            at = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                      min(len(got), len(want)))
            require(got == want, f"openai: request {i} (prompt {len(prompts[i])}): tokens differ "
                                 f"from the in-process run's from position {at}")
            require(body["usage"]["completion_tokens"] == 64
                    and body["usage"]["prompt_tokens"] == len(prompts[i]),
                    f"openai: request {i} usage {body['usage']}")
        require(replays == steps > 0, f"openai: {replays} replays for {steps} steps")
        for k in ("qmm_int8", "decode_attention", "flash_prefill"):
            require(launches[k] > 0, f"openai: {k} was never launched while serving over HTTP")
        first = max(r.profile.first_token_time for r in http_reqs)
        out.update(
            requests=len(http_reqs), tokens=sum(len(r.output_tokens) for r in http_reqs),
            # as _served: from the last first token to the host's end of the run
            decode_tok_s=sum(len(r.output_tokens) - 1 for r in http_reqs) / (t_end - first),
            mean_ttft_ms=1e3 * float(np.mean([r.profile.ttft for r in http_reqs])),
            wall_s=t_end - t_start, steps=steps, replays=replays, launches=launches,
            admissions=len({r.profile.first_token_time for r in http_reqs}))  # one a prefill

        # 3. the longest prompt streamed: its deltas join to step 2's text
        deltas, finishes, last, first_s = _stream(port, {"prompt": prompts[0], "max_tokens": 64,
                                                        "temperature": 0})
        require("".join(deltas) == answers[0][1]["choices"][0]["text"],
                "openai: the streamed text differs from the completion's")
        require(last == "[DONE]" and finishes[-1] == "stop",
                f"openai: the stream ended with {finishes[-1:]} and {last!r}")
        out.update(stream_chunks=len([d for d in deltas if d]), stream_first_ms=1e3 * first_s)
        idle()

        # 4. refusals: an oversize prompt at registration, and bad JSON
        code, body = _post(port, {"prompt": [5] * 1024, "max_tokens": 4})
        require(code == 400 and "max_seq_len" in body["error"]["message"],
                f"openai: a 1024-token prompt got {code} {body}")
        require(loop.is_alive(), "openai: the serving loop died on an oversize prompt")
        code, body = _post(port, None, raw=b"{not json")
        require(code == 400, f"openai: bad JSON got {code} {body}")
    finally:
        llm.stop_server()
        srv.shutdown()
        srv.server_close()
    # 5. a clean stop
    require(rm._server_thread is None and not loop.is_alive(), "openai: the loop did not join")
    running = [g for g, r in rm._requests.items() if r.state == "RUNNING"]
    require(not running, f"openai: requests left RUNNING: {running}")
    rows = per_op_profile(spec, engine.params, batch=1, seq=32)
    for line in rows:
        log(f"  {line} [{card}]")
    rm.close()
    out.update(card=card, per_op=rows, base=dict(decode_tok_s=base["decode_tok_s"],
                                                 mean_ttft_ms=base["mean_ttft_ms"]))
    log(f"  openai: {out['requests']} requests over HTTP, {out['tokens']} tokens in "
        f"{out['wall_s']:.3f} s, {out['admissions']} admissions: decode "
        f"{out['decode_tok_s']:.1f} tok/s, mean TTFT {out['mean_ttft_ms']:.1f} ms; in-process "
        f"run of this call: decode {base['decode_tok_s']:.1f} tok/s, mean TTFT "
        f"{base['mean_ttft_ms']:.1f} ms [{card}]")
    log(f"  openai: {out['steps']} steps, {out['replays']} replays; launches "
        f"{json.dumps(out['launches'])}")
    log(f"  openai: stream of the {len(prompts[0])}-token prompt: first non-empty chunk after "
        f"{out['stream_first_ms']:.1f} ms, {out['stream_chunks']} chunks [{card}]")
    del engine, rm, llm
    torch.cuda.empty_cache()
    return out


# a 160M-class draft at the 7B head_dim (the pair construction needs one
# head_dim), the widths of bench_spec.py's DRAFT_7B
DRAFT_160M = dict(LLAMA2_7B, hidden_size=768, num_layers=12, num_heads=6, num_kv_heads=6,
                  intermediate_size=3072)
PREFIX = 20  # tokens of every request that must equal incremental decoding's


DRAFT_B_NOISE = 0.05  # draft B: draft A plus seeded noise of this RMS relative to each tensor's
CATCHUP_REL = 5e-2  # a caught-up draft cache's rel L2 against a fresh prefill, bf16


def _prefix_equal(what: str, got_reqs, want_reqs) -> list:
    """Per request, the tokens of ``got_reqs`` equal to ``want_reqs``'s before
    the first difference; each must reach ``PREFIX``."""
    same = []
    for g, w in zip(got_reqs, want_reqs):
        a, b = g.output_tokens, w.output_tokens
        n = next((j for j in range(len(a)) if a[j] != b[j]), len(a))
        same.append(n)
        if n < PREFIX:
            log(f"  {what} request {g.guid}: first difference at token {n}: {a[:n + 2]} "
                f"against incremental {b[:n + 2]}")
    log(f"  {what}: tokens equal to incremental before the first difference, per request: "
        f"{same}")
    require(min(same) >= PREFIX,
            f"{what} output differs from incremental within the first {PREFIX} tokens")
    return same


def _ptrs(tree) -> list:
    """Every tensor's data_ptr in a parameter tree, in key order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _ptrs(tree[k])]
    if hasattr(tree, "q"):
        return [x.data_ptr() for x in (tree.q, tree.scale, tree.offset) if x is not None]
    return [tree.data_ptr()]


def _shares_verifier(engines) -> bool:
    first = engines[0]
    return all(_ptrs(e.llm_params) == _ptrs(first.llm_params)
               and e.llm_cache.k.data_ptr() == first.llm_cache.k.data_ptr()
               and e.llm_cache.v.data_ptr() == first.llm_cache.v.data_ptr() for e in engines)


def _snapshot_drafts_at_retire(rm) -> dict:
    """Wrap ``rm._retire``: before a slot is freed, copy each draft cache's
    rows below that draft's committed length (a later catch-up writes junk
    into free slots). Returns {guid: [(length, k rows, v rows) per draft]}."""
    snaps = {}
    retire = rm._retire

    def snapshot_then_retire(slot):
        req = rm._slots[slot]
        snaps[req.guid] = [(int(lens[slot]), e.ssm_cache.k[:, slot, :, :int(lens[slot])].clone(),
                            e.ssm_cache.v[:, slot, :, :int(lens[slot])].clone())
                           for e, lens in zip(rm.engines, rm._ssm_lens)]
        retire(slot)

    rm._retire = snapshot_then_retire
    return snaps


def _catchup_rule(engines, reqs, snaps) -> float:
    """Each draft's committed rows at retirement against a fresh prefill of
    the request's history through the same draft (flash prefill, bf16):
    relative L2 over K and V within ``CATCHUP_REL``. Returns the largest."""
    import torch

    from flexflow_tpu_torch.models import decoder

    worst, rows = 0.0, 0
    for req in reqs:
        for i, (n, k, v) in enumerate(snaps[req.guid]):
            if n == 0:
                continue
            e = engines[i]
            toks = torch.tensor([req.tokens[:n]], device=e.device)
            pos = torch.arange(n, dtype=torch.int32, device=e.device)[None]
            with torch.no_grad():
                _, (fk, fv) = decoder.forward(e.ssm_spec, e.ssm_params, toks, pos, flash=True,
                                              return_kv=True)
            want = torch.cat([fk[:, 0].permute(0, 2, 1, 3).float(),
                              fv[:, 0].permute(0, 2, 1, 3).float()])
            got = torch.cat([k.float(), v.float()])
            rel = ((got - want).norm() / want.norm()).item()
            require(rel <= CATCHUP_REL, f"draft {i} cache of request {req.guid}: rel L2 {rel:.3g} "
                                        f"against a fresh prefill of {n} tokens > {CATCHUP_REL}")
            worst, rows = max(worst, rel), rows + n
    require(rows > 0, "no draft cache rows were checked")
    return worst


def _noisy(params, gen, rel: float):
    """``params`` plus seeded normal noise of RMS ``rel`` x each tensor's RMS."""
    import torch

    if isinstance(params, dict):
        return {k: _noisy(params[k], gen, rel) for k in sorted(params)}
    noise = torch.randn(params.shape, generator=gen, device=params.device)
    return (params.float() + noise * rel * params.float().pow(2).mean().sqrt()).to(params.dtype)


def two_draft_runs(engine, dspec, dparams, prompts, card) -> dict:
    """Draft B (draft A's architecture and weights plus ``DRAFT_B_NOISE``
    noise, tree width 1 and depth 6) on ``engine``'s verifier tensors and
    cache, beside ``engine`` (draft A): the prompts served by rotation
    (``MultiSSMSpecManager``, fused: every iteration a replay of one engine's
    graph) and then merged (stepwise: 1 + 12 + 6 = 19 nodes a slot). Returns
    {mode: (requests, stats)}."""
    import torch

    from flexflow_tpu_torch.serving.spec_manager import MultiSSMSpecManager
    from flexflow_tpu_torch.serving.speculative import SpecEngine
    from flexflow_tpu_torch.utils.profiling import StepTimer

    dev = engine.device
    dparams_b = _noisy(dparams, torch.Generator(device=dev).manual_seed(1), DRAFT_B_NOISE)
    engine_b = SpecEngine(engine.llm_spec, engine.llm_params, dspec, dparams_b, beam_width=1,
                          beam_depth=6, max_requests_per_batch=engine.max_requests,
                          max_seq_len=engine.max_seq_len, cache_dtype=torch.bfloat16,
                          device=dev, llm_cache=engine.llm_cache)
    engines = [engine, engine_b]
    require(_shares_verifier(engines),
            "the two drafts' engines do not share the verifier's tensors and cache")
    log(f"  draft B: draft A + noise at {DRAFT_B_NOISE} of each tensor's RMS (seed 1), width 1 "
        f"depth 6; the engines share the verifier's {len(_ptrs(engine.llm_params))} tensors and "
        f"its cache (data_ptr)")
    runs = {}
    for mode in ("rotation", "merged"):
        merged = mode == "merged"
        managers = [MultiSSMSpecManager(engines, merged=merged, fused=not merged)
                    for _ in range(2)]
        managers[0]._rr = 1  # the warm-up's first turn is draft B's: its graphs are captured
        rm = managers[1]
        rm.timer = StepTimer()  # host wall time per scheduling phase
        snaps = _snapshot_drafts_at_retire(rm)
        reqs, out = _served(rm, prompts, 64, engine.llm_spec.vocab_size,
                            f"{mode} of two drafts", warm=managers[0], replayed=not merged)
        del rm._retire  # the snapshot wrapper's reference cycle would keep the engines alive
        out["phases_ms"] = {k: 1e3 * v for k, v in rm.timer.totals.items()}
        out.update(card=card, mean_verified_tokens_per_step=rm.mean_verified_tokens_per_step,
                   tree=rm._merged_t if merged else [e.tree for e in engines])
        out["catchup_max_rel_l2"] = _catchup_rule(engines, reqs, snaps)
        _log_served(f"{mode} of two drafts", out, card)
        log(f"  {mode}: mean verified tokens per step {out['mean_verified_tokens_per_step']:.3f} "
            f"(trees {out['tree']}); draft caches caught up: largest rel L2 against a fresh "
            f"prefill {out['catchup_max_rel_l2']:.3g} (limit {CATCHUP_REL}) [{card}]")
        runs[mode] = (reqs, out)
        del managers, rm, snaps
    require(_shares_verifier(engines), "the engines stopped sharing the verifier")
    del engine_b, engines, dparams_b
    torch.cuda.empty_cache()
    return runs


def spec_phase(card: str, with_profile: bool) -> dict:
    """Tree-speculative serving of LLaMA-2-7B INT4 with a 160M-class bf16
    draft that the verifier block-embeds (``utils/spec_pair``), through
    ``SpecEngine`` + the fused, pipelined ``SpecRequestManager``; then a
    second draft beside it, rotated and merged (``two_draft_runs``); and the
    incremental INT4 run of the same verifier they must all agree with."""
    import torch

    from flexflow_tpu_torch.config import config as ffconfig
    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.serving.spec_manager import SpecRequestManager
    from flexflow_tpu_torch.serving.speculative import SpecEngine, tree_size
    from flexflow_tpu_torch.specs import ModelSpec
    from flexflow_tpu_torch.utils.spec_pair import embed_draft_in_verifier

    dev = torch.device("cuda")
    dspec, vspec = ModelSpec(**DRAFT_160M), ModelSpec(**LLAMA2_7B)
    t0 = time.perf_counter()
    dparams = params_lib.init_params(dspec, torch.Generator(device=dev).manual_seed(0),
                                     torch.bfloat16, dev)
    vparams = embed_draft_in_verifier(dspec, dparams, vspec, bits=4, group_size=128,
                                      dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    log(f"  weights: 160M-class bf16 draft and the LLaMA-2-7B INT4 verifier embedding it "
        f"in {time.perf_counter() - t0:.1f} s")
    width, depth, seq = 3, 4, 1024
    # LLM.compile's clamp: the speculation margin stays within a quarter of the context
    horizon = max(1, min(ffconfig.spec_horizon, seq // (4 * (tree_size(width, depth) + 1))))
    prompts = _prompts(vspec.vocab_size)
    engine = SpecEngine(vspec, vparams, dspec, dparams, beam_width=width, beam_depth=depth,
                        max_requests_per_batch=8, max_seq_len=seq, cache_dtype=torch.bfloat16,
                        device=dev)
    managers = [SpecRequestManager(engine, fused=True, spec_horizon=horizon,
                                   pipelined=horizon > 1, pipeline_depth=ffconfig.pipeline_depth)
                for _ in range(2)]  # a warm-up one, so the measured one counts only its run
    rm = managers[1]
    spec_reqs, out = _served(rm, prompts, 64, vspec.vocab_size, "spec", warm=managers[0])
    out.update(spec_horizon=horizon, pipeline_depth=rm.pipeline_depth,
               mean_verified_tokens_per_step=rm.mean_verified_tokens_per_step)
    lens = engine._h([len(p) for p in prompts])
    roots = engine._h([(r.output_tokens[0] + 1) % vspec.vocab_size for r in spec_reqs])
    _replay_check(f"speculative horizon ({horizon} iterations, 8 slots)",
                  lambda replay: engine.greedy_horizon_async(lens, roots, horizon, replay=replay),
                  [*engine.llm_cache, *engine.ssm_cache])
    if with_profile:
        log("[profile] one 8-iteration horizon of the speculative engine")
        out["profile"] = spec_profile(engine, prompts)
    del rm, managers
    two = two_draft_runs(engine, dspec, dparams, prompts, card)
    del engine
    torch.cuda.empty_cache()

    engine = InferenceEngine(vspec, vparams, max_requests_per_batch=8, max_seq_len=seq,
                             max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev)
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    try:
        incr_reqs, incr = _served(rm, prompts, 64, vspec.vocab_size, "incremental INT4")
    finally:
        rm.close()
    del engine, rm, vparams, dparams
    torch.cuda.empty_cache()

    out["card"] = card
    out["incremental"] = incr
    _log_served("speculative", out, card)
    log(f"  mean verified tokens per step {out['mean_verified_tokens_per_step']:.3f} "
        f"(spec_horizon {horizon}, width {width}, depth {depth}) [{card}]")
    _log_served("incremental INT4", incr, card)
    out["tokens_equal_to_incremental"] = _prefix_equal("one draft", spec_reqs, incr_reqs)
    for mode, (reqs, stats) in two.items():
        stats["tokens_equal_to_incremental"] = _prefix_equal(f"{mode} of two drafts", reqs,
                                                             incr_reqs)
        out[mode] = stats
        log(f"  {mode} of two drafts against one draft: decode {stats['decode_tok_s']:.1f} "
            f"against {out['decode_tok_s']:.1f} tok/s, mean TTFT {stats['mean_ttft_ms']:.1f} "
            f"against {out['mean_ttft_ms']:.1f} ms, peak {stats['peak_mem_gib']:.2f} against "
            f"{out['peak_mem_gib']:.2f} GiB, verified/step "
            f"{stats['mean_verified_tokens_per_step']:.3f} against "
            f"{out['mean_verified_tokens_per_step']:.3f} [{card}]")
    for k in ("qmm_int4", "decode_attention", "flash_prefill"):
        require(out["launches"][k] > 0, f"{k} was never launched while serving speculatively")
        for mode in two:
            require(out[mode]["launches"][k] > 0, f"{k} was never launched in the {mode} run")
    require(out["mean_verified_tokens_per_step"] > 1,
            f"mean verified tokens per step {out['mean_verified_tokens_per_step']} <= 1")
    return out


# ---------------------------------------------------------------------------
# Mixtral-8x7B (MoE)
# ---------------------------------------------------------------------------


def mixtral_spec(num_layers=None, impl: str = "dense"):
    """Mixtral-8x7B's spec as ``from_hf_config`` gives it (the dense MoE
    form), with ``num_layers`` and the MoE form ``impl`` if given."""
    from flexflow_tpu_torch.specs import from_hf_config

    spec = from_hf_config(MIXTRAL_8X7B)
    return dataclasses.replace(spec, num_layers=num_layers or spec.num_layers,
                               moe=dataclasses.replace(spec.moe, impl=impl))


def moe_launches_per_forward(spec) -> int:
    """qmm_int8 calls in one forward of a MoE model with fused wq|wk|wv:
    wqkv, wo and 3 per expert a layer, and the lm_head."""
    return spec.num_layers * (2 + 3 * spec.moe.num_experts) + 1


class RoutingLog:
    """Records every ``ops/moe.route_topk`` call's routing probabilities
    and chosen experts (on the host) while active."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch

        from flexflow_tpu_torch.ops import moe

        self._orig = orig = moe.route_topk

        def route(logits, top_k):
            w, i = orig(logits, top_k)
            self.calls.append((torch.softmax(logits.float(), dim=-1).cpu(), i.cpu()))
            return w, i

        moe.route_topk = route
        return self

    def __exit__(self, *exc):
        from flexflow_tpu_torch.ops import moe

        moe.route_topk = self._orig


def routing_rule(gpu_calls, cpu_calls, rows, n_layers: int) -> dict:
    """The routing comparison of two runs' ``RoutingLog``s. ``rows[c]`` maps
    call c's row indices to token ids (None: a padding row, skipped);
    calls go layer by layer. A token is clean at a layer if its top-k set
    agreed at every earlier layer. Per layer, the observed probability
    error is the largest |p_gpu - p_cpu| over clean tokens whose sets agree
    there; a token is excluded where it is clean and the CPU's 2nd-vs-3rd
    probability margin is within twice that error. Every token not
    excluded must agree at every layer. Returns the excluded and the
    flipped token ids (a flipped token's sets differ at some layer) and the
    observed errors."""
    import torch

    layers = [[] for _ in range(n_layers)]  # per layer: (token, p_gpu, p_cpu, agree)
    for c, ((pg, ig), (pc, ic)) in enumerate(zip(gpu_calls, cpu_calls)):
        agree = (ig.sort(-1).values == ic.sort(-1).values).all(-1)
        for r, tok in enumerate(rows[c // n_layers]):
            if tok is not None:
                layers[c % n_layers].append((tok, pg[r], pc[r], bool(agree[r])))
    clean = {tok for tok, *_ in layers[0]}
    excluded, flipped, errs = set(), set(), []
    for per in layers:
        ok = [(t, g, c) for t, g, c, a in per if t in clean and a]
        err = max(((g - c).abs().max().item() for _, g, c in ok), default=0.0)
        errs.append(err)
        for tok, g, c, a in per:
            if tok not in clean:
                continue
            top3 = torch.topk(c, 3).values
            if top3[1] - top3[2] <= 2 * err:
                excluded.add(tok)
            elif not a:
                raise PhaseError(f"routing differs for token {tok} with a 2nd-vs-3rd margin "
                                 f"{(top3[1] - top3[2]).item():.3g} > 2 x the observed error "
                                 f"{err:.3g}")
            if not a:
                flipped.add(tok)
        clean -= {t for t, _, _, a in per if not a}
    return dict(routed_tokens=len(layers[0]), excluded=sorted(excluded), flipped=sorted(flipped),
                prob_err_per_layer=errs)


def logits_rule(g, c, keep, what: str) -> dict:
    """The cross-check's logit rule on rows ``keep``: max |err| within 5% of
    the CPU logits' magnitude, and greedy tokens equal wherever the CPU's
    top-2 margin exceeds twice the observed error."""
    import torch

    g, c = g[keep], c[keep]
    require(g.numel() > 0, f"{what}: every logits row left out")
    require(bool(torch.isfinite(g).all()), f"{what}: logits not finite")
    err = (g - c).abs().max().item()
    scale = c.abs().max().item()
    tol = 5e-2 * scale
    require(err <= tol, f"{what}: logits max|err| {err} > {tol}")
    top2 = torch.topk(c, 2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = g.argmax(-1) == c.argmax(-1)
    require(bool(agree[decided].all()),
            f"{what}: greedy tokens disagree at decided positions: {agree.tolist()}")
    return dict(max_abs_err=err, tol=tol, tokens_equal=int(agree.sum()),
                tokens=int(agree.numel()), decided=int(decided.sum()))


def crosscheck_mixtral(dev=None, spec=None, steps: int = 2) -> dict:
    """2 layers at full Mixtral-8x7B width, INT8 group 128 (streaming init,
    seed 1): a prefill of 4 requests and ``steps`` teacher-forced decode
    steps through the kernels on ``dev`` against the plain versions on the
    CPU, holding both the logits and every token's routing
    (``routing_rule``)."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import _params_to

    dev = dev or torch.device("cuda")
    spec = spec or mixtral_spec(num_layers=2)
    gpu = decoder.fuse_qkv_params(spec, params_lib.init_quantized_params(
        spec, torch.Generator(device=dev).manual_seed(1), bits=8, group_size=128,
        dtype=torch.bfloat16, device=dev))
    cpu = _params_to(gpu, torch.device("cpu"))
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    lens = np.array([20, 13, 27, 9], np.int32)
    nb, t, s_max = len(lens), 32, 64
    toks = np.zeros((nb, t), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(3, spec.vocab_size, n)
    sides = (("gpu", dev, gpu), ("cpu", torch.device("cpu"), cpu))
    caches, logits, routes = {}, {}, {}
    for name, d, params in sides:
        cache = decoder.init_kv_cache(spec, nb, s_max, torch.bfloat16, d)
        ln = torch.as_tensor(lens, device=d)
        with torch.no_grad(), RoutingLog() as rec:
            lg, (k, v) = decoder.forward(
                spec, params, torch.as_tensor(toks, device=d),
                torch.arange(t, dtype=torch.int32, device=d)[None].expand(nb, t), lengths=ln,
                flash=True, return_kv=True, logits_at=ln - 1)
        decoder.commit_kv_windows(cache.k, cache.v, k.permute(0, 1, 3, 2, 4),
                                  v.permute(0, 1, 3, 2, 4), [0] * nb)
        caches[name], logits[name], routes[name] = cache, [lg.float().cpu()], rec.calls
    # token ids: (request, position); the dense form routes the padding too
    rows = [[(b, p) if p < lens[b] else None for b in range(nb) for p in range(t)]]
    cur = logits["gpu"][0].argmax(-1)  # the GPU's greedy tokens drive both sides
    for i in range(steps):
        for name, d, params in sides:
            with torch.no_grad(), RoutingLog() as rec:
                lg, _ = decoder.forward_cached(
                    spec, params, cur[:, None].to(d), caches[name],
                    torch.as_tensor(lens + i, device=d), write_start=lens + i)
            logits[name].append(lg[:, 0].float().cpu())
            routes[name] += rec.calls
        rows.append([(b, int(lens[b]) + i) for b in range(nb)])
        cur = logits["gpu"][-1].argmax(-1)
    routing = routing_rule(routes["gpu"], routes["cpu"], rows, spec.num_layers)
    log(f"  cross-check Mixtral-width INT8 (2 layers), routing of {routing['routed_tokens']} "
        f"tokens x {spec.num_layers} layers: {len(routing['flipped'])} tokens with a differing "
        f"top-2 set, {len(routing['excluded'])} near-ties excluded from the routing check, "
        f"probability error per layer {[f'{e:.3g}' for e in routing['prob_err_per_layer']]}; "
        f"flipped (request, position): {routing['flipped']}")
    g, c = torch.stack(logits["gpu"]), torch.stack(logits["cpu"])  # [steps + 1, B, V]
    require(g.shape == (steps + 1, nb, spec.vocab_size), f"logits shaped {tuple(g.shape)}")
    # a flipped token's FFN output differs wholesale, and the logits at its
    # position and past it (through attention) follow: those rows are left out
    positions = [[int(lens[b]) - 1 + i for b in range(nb)] for i in range(steps + 1)]
    keep = torch.tensor([[not any(b == fb and p <= pos for fb, p in routing["flipped"])
                          for b, pos in enumerate(row)] for row in positions])
    out = logits_rule(g, c, keep, "mixtral cross-check")
    out.update(routing, excluded=len(routing["excluded"]), flipped=len(routing["flipped"]),
               logit_rows_excluded=int((~keep).sum()), seconds=time.perf_counter() - t0)
    log(f"  cross-check logits: max|err| {out['max_abs_err']:.4g} (tol {out['tol']:.4g}); greedy "
        f"tokens equal {out['tokens_equal']}/{out['tokens']} ({out['decided']} beyond the error "
        f"margin); {out['logit_rows_excluded']} of {keep.numel()} logit rows left out after a "
        f"flipped token; {out['seconds']:.1f} s")
    del gpu, cpu, caches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def prefill_forms(engine, prompts) -> dict:
    """One batched prefill of ``prompts`` (the served 8 x 1024 bucket)
    through ``decoder.forward`` with the dense and with the ragged MoE form
    on the engine's weights, each timed on the host clock around a
    synchronised call (the ragged form run once before, untimed); their
    logits at each request's last prompt position must agree by the
    cross-check's rule."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder

    dev = engine.device
    b = len(prompts)
    bucket = max(engine.prefill_bucket(len(p)) for p in prompts)
    toks = np.zeros((b, bucket), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    tok = torch.as_tensor(toks, device=dev)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    pos = torch.arange(bucket, dtype=torch.int32, device=dev)[None].expand(b, bucket)
    specs = {"dense": engine.spec,
             "ragged": dataclasses.replace(engine.spec, moe=dataclasses.replace(
                 engine.spec.moe, impl="ragged"))}

    def run(form):
        with torch.no_grad():
            return decoder.forward(specs[form], engine.params, tok, pos, lengths=lens,
                                   flash=True, logits_at=lens - 1)[0].float()

    run("ragged")
    out, ms = {}, {}
    for form in ("dense", "ragged"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[form] = run(form)
        torch.cuda.synchronize()
        ms[form] = (time.perf_counter() - t0) * 1e3
    rule = logits_rule(out["ragged"].cpu(), out["dense"].cpu(), slice(None),
                       "ragged vs dense prefill")
    rule.update(dense_ms=ms["dense"], ragged_ms=ms["ragged"], bucket=[b, bucket],
                bitwise_equal=bool(torch.equal(out["dense"], out["ragged"])))
    log(f"  batched prefill {b}x{bucket}: dense {ms['dense']:.1f} ms, ragged {ms['ragged']:.1f} ms "
        f"(host clock, synchronised); logits at the last prompt positions max|err| "
        f"{rule['max_abs_err']:.4g} (tol {rule['tol']:.4g}), bitwise equal: {rule['bitwise_equal']}")
    return rule


def mixtral_phase(card: str, with_profile: bool) -> dict:
    """Mixtral-8x7B INT8 at full width and depth: the cross-check, the
    streaming init, the served run with its predicted launch counts, one
    replayed horizon against the uncaptured body, and the dense and ragged
    prefills."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager

    out = {"crosscheck": crosscheck_mixtral()}
    dev = torch.device("cuda")
    spec = mixtral_spec()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = params_lib.init_quantized_params(
        spec, torch.Generator(device=dev).manual_seed(0), bits=8, group_size=128,
        dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["weights_gib"] = torch.cuda.memory_allocated() / 2**30
    out["init_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"  weights: random Mixtral-8x7B INT8 (group 128), streaming init in {out['init_s']:.1f} s: "
        f"{out['weights_gib']:.2f} GiB held, {out['init_peak_gib']:.2f} GiB peak allocated [{card}]")
    engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                             max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev)
    del params
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    prompts = _prompts(spec.vocab_size)
    try:
        reqs, served = _served(rm, prompts, 64, spec.vocab_size, "mixtral")
        out.update(served)
        n, steps = spec.num_layers, served["replays"]
        prefills = served["launches"]["flash_prefill"] // n
        want = {"qmm_int8": moe_launches_per_forward(spec) * (steps + prefills),
                "decode_attention": n * steps, "flash_prefill": n * prefills}
        got = {k: served["launches"][k] for k in want}
        require(prefills >= 1 and got == want,
                f"mixtral launches {got} != the predicted {want} ({steps} decode steps, "
                f"{prefills} prefills)")
        out["predicted_launches"] = want
        lens = np.array([len(p) for p in prompts], np.int32)
        toks = np.array([(r.output_tokens[0] + 1) % spec.vocab_size for r in reqs], np.int32)
        _replay_check("mixtral decode horizon (16 steps, 8 slots)",
                      lambda replay: [engine.greedy_horizon_async(lens, toks, 16, replay=replay)],
                      list(engine.cache))
        out["prefill_forms"] = prefill_forms(engine, prompts)
        if with_profile:
            log("[profile] one decode horizon and one batched prefill of Mixtral-8x7B INT8")
            out["profile"] = profile_phase(engine, prompts)
    finally:
        rm.close()
    out["card"] = card
    _log_served("mixtral", out, card)
    log(f"  launches as predicted: {moe_launches_per_forward(spec)} qmm_int8 a forward, "
        f"{spec.num_layers} decode_attention a decode step, {spec.num_layers} flash_prefill a "
        f"prefill [{card}]")
    del rm
    out["spec"] = mixtral_spec_run(engine, reqs, prompts, out, card)
    del engine
    torch.cuda.empty_cache()
    return out


MIXTRAL_SPEC_PEAK_GIB = 4.0  # the speculative run's peak memory over the incremental run's


def mixtral_spec_run(engine, incr_reqs, prompts, incr: dict, card: str) -> dict:
    """Mixtral-8x7B INT8 as the verifier under ``SpecEngine`` (dense MoE
    form, captured), on the incremental engine's own weight tensors, with
    the 160M-class draft (random bf16 weights, seed 0: it speculates blind,
    so about one token verifies a step); width 3, depth 4, fused and
    pipelined as ``LLM.compile`` builds it. Every request's first ``PREFIX``
    tokens equal the incremental run's, every greedy iteration is a replay,
    one replayed horizon equals the uncaptured body bitwise, qmm_int8,
    decode_attention (the tree form in the verify) and flash_prefill launch,
    and the peak memory stays within ``MIXTRAL_SPEC_PEAK_GIB`` of the
    incremental run's."""
    import torch

    from flexflow_tpu_torch.config import config as ffconfig
    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.spec_manager import SpecRequestManager
    from flexflow_tpu_torch.serving.speculative import SpecEngine, tree_size
    from flexflow_tpu_torch.specs import ModelSpec

    dev = engine.device
    spec = engine.spec
    dspec = ModelSpec(**DRAFT_160M)
    require(dspec.vocab_size == spec.vocab_size, "the draft and Mixtral need one vocabulary")
    dparams = params_lib.init_params(dspec, torch.Generator(device=dev).manual_seed(0),
                                     torch.bfloat16, dev)
    width, depth, seq = 3, 4, engine.max_seq_len
    horizon = max(1, min(ffconfig.spec_horizon, seq // (4 * (tree_size(width, depth) + 1))))
    spec_engine = SpecEngine(spec, engine.params, dspec, dparams, beam_width=width,
                             beam_depth=depth, max_requests_per_batch=engine.max_requests,
                             max_seq_len=seq, cache_dtype=torch.bfloat16, device=dev)
    require(_ptrs(spec_engine.llm_params) == _ptrs(engine.params),
            "the speculative engine copied Mixtral's weights")
    require(spec_engine.graphs is not None, "the dense-form Mixtral engine captures nothing")
    managers = [SpecRequestManager(spec_engine, fused=True, spec_horizon=horizon,
                                   pipelined=horizon > 1, pipeline_depth=ffconfig.pipeline_depth)
                for _ in range(2)]
    rm = managers[1]
    reqs, out = _served(rm, prompts, 64, spec.vocab_size, "mixtral speculative",
                        warm=managers[0])
    out.update(card=card, spec_horizon=horizon,
               mean_verified_tokens_per_step=rm.mean_verified_tokens_per_step,
               verify_rows=engine.max_requests * spec_engine.tree)
    _log_served("mixtral speculative", out, card)
    log(f"  mixtral speculative: mean verified tokens per step "
        f"{out['mean_verified_tokens_per_step']:.3f} (a random draft), {out['steps']} iterations "
        f"of a {out['verify_rows']}-row verify; decode {out['decode_tok_s']:.1f} against "
        f"incremental {incr['decode_tok_s']:.1f} tok/s, mean TTFT {out['mean_ttft_ms']:.1f} "
        f"against {incr['mean_ttft_ms']:.1f} ms, peak {out['peak_mem_gib']:.2f} against "
        f"{incr['peak_mem_gib']:.2f} GiB [{card}]")
    lens = spec_engine._h([len(p) for p in prompts])
    roots = spec_engine._h([(r.output_tokens[0] + 1) % spec.vocab_size for r in reqs])
    _replay_check(f"mixtral speculative horizon ({horizon} iterations, 8 slots)",
                  lambda replay: spec_engine.greedy_horizon_async(lens, roots, horizon,
                                                                  replay=replay),
                  [*spec_engine.llm_cache, *spec_engine.ssm_cache])
    out["tokens_equal_to_incremental"] = _prefix_equal("mixtral speculative", reqs, incr_reqs)
    for k in ("qmm_int8", "decode_attention", "flash_prefill"):
        require(out["launches"][k] > 0, f"{k} was never launched in the mixtral speculative run")
    require(out["peak_mem_gib"] <= incr["peak_mem_gib"] + MIXTRAL_SPEC_PEAK_GIB,
            f"mixtral speculative peak {out['peak_mem_gib']:.2f} GiB > the incremental run's "
            f"{incr['peak_mem_gib']:.2f} + {MIXTRAL_SPEC_PEAK_GIB}")
    del rm, managers, spec_engine, dparams
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# CPU offload
# ---------------------------------------------------------------------------

# Run (c)'s depth. bf16 Mixtral-8x7B holds 2.903 GB (2.703 GiB) of layer
# weights a layer, 86.5 GiB for all 32. The one-H100 machine has 101 GiB
# of memory, and a Python process holding a CUDA context sees 96.5 GiB
# available (the card phase's "host memory" line): under 100 GiB, so the
# run takes the most layers that leave 12 GiB free, 31 (83.8 GiB pinned).
# Fixed here: the phase never shrinks itself at run time.
OFFLOAD_LAYERS = 31
OFFLOAD_NEW_TOKENS = 16  # runs (b) and (c): decode steps / tokens a request
OFFLOAD_PEAK_SHARE = 0.25  # run (c)'s peak device memory against the layer stack's bytes


def _meminfo_gib(path: str, key: str) -> float:
    """A ``kB`` field of ``/proc/meminfo`` or ``/proc/self/status``, in GiB."""
    with open(path) as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) / 2**20
    raise PhaseError(f"no {key} in {path}")


def _mem_available_gib() -> float:
    return _meminfo_gib("/proc/meminfo", "MemAvailable")


def _rss_gib() -> float:
    """This process's resident memory (page-locked pages included)."""
    return _meminfo_gib("/proc/self/status", "VmRSS")


def _stepped_logits(engine, prompts, steps: int, layers=None):
    """The engine's batched prefill (flash, K/V written into its cache, as
    ``prefill_batch_to_slots_async`` does) of ``prompts`` into slots 0..n-1,
    then ``steps`` greedy decode steps through ``forward_cached``, straight
    on the engine's parameters (``layers`` in place of its layers, if
    given) and cache. Returns (logits [steps + 1, n, V]
    f32: the prefill's at each last prompt position, then each step's;
    wall seconds of the prefill and of each step, synchronised)."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.models.decoder import to_device

    n = len(prompts)
    spec, dev = engine.spec, engine.device
    cache = decoder.KVCache(engine.cache.k[:, :n], engine.cache.v[:, :n])
    bucket = max(engine.prefill_bucket(len(p)) for p in prompts)
    toks = np.zeros((n, bucket), np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    tk, ln = to_device(toks, dev), to_device(lens, dev)
    pos = torch.arange(bucket, dtype=torch.int32, device=dev)[None].expand(n, bucket)

    def sink(layer, k, v):
        decoder.commit_kv_windows(cache.k[layer:layer + 1], cache.v[layer:layer + 1],
                                  k.permute(0, 2, 1, 3)[None].to(cache.k.dtype),
                                  v.permute(0, 2, 1, 3)[None].to(cache.v.dtype),
                                  np.zeros(n, np.int64), list(range(n)))

    params = engine.params if layers is None else {**engine.params, "layers": layers}
    walls, out = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        lg, _ = decoder.forward(spec, params, tk, pos, lengths=ln, flash=True,
                                kv_sink=sink, logits_at=ln - 1)
        out.append(lg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        cur, cl = lg.argmax(-1).to(torch.int32), ln.clone()
        for _ in range(steps):
            t0 = time.perf_counter()
            lg, _ = decoder.forward_cached(spec, params, cur[:, None], cache, cl)
            out.append(lg[:, 0])
            cur, cl = lg[:, 0].argmax(-1).to(torch.int32), cl + 1
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    return torch.stack(out).float(), walls


def _h2d_gbps(reps: int = 3) -> float:
    """Host-to-device rate of one plain copy of 1 GiB from page-locked memory
    (the layer store's kind), mean of ``reps`` after a warm-up (CUDA events)."""
    import torch

    from flexflow_tpu_torch.models.layer_store import pinned_empty

    host = pinned_empty((1 << 30,), torch.uint8)
    dev = torch.empty((1 << 30,), dtype=torch.uint8, device="cuda")
    dev.copy_(host, non_blocking=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dev.copy_(host, non_blocking=True)
    end.record()
    end.synchronize()
    return reps * (1 << 30) / (start.elapsed_time(end) / 1e3) / 1e9


def _served_stamped(rm, prompts, max_new: int, vocab_size: int, path: str):
    """``_served`` (no replays) noting the host time each of the engine's
    fetches returns: at horizon 1, not pipelined, each closes the prefill
    or a decode step. Returns (requests, stats, times). The engine's own
    ``fetch`` is back in place on return, and no reference to the engine
    outlives this call."""
    engine, stamps = rm.engine, []
    fetch = engine.fetch

    def timed_fetch(x):
        vals = fetch(x)
        stamps.append(time.monotonic())
        return vals

    engine.fetch = timed_fetch
    try:
        reqs, served = _served(rm, prompts, max_new, vocab_size, path, replayed=False)
    finally:
        del engine.fetch
    return reqs, served, stamps


def offload_llama_run(card: str) -> dict:
    """Run (a): LLaMA-2-7B INT8 resident against offload, the serve traffic."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    dev = torch.device("cuda")
    spec = ModelSpec(**LLAMA2_7B)
    t0 = time.perf_counter()
    params = params_lib.init_quantized_params(
        spec, torch.Generator(device=dev).manual_seed(0), bits=8, group_size=128,
        dtype=torch.bfloat16, device=dev, host_layers=True)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0}
    prompts = _prompts(spec.vocab_size)
    reqs = {}
    for offload in (False, True):
        name = "offload" if offload else "resident"
        engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                                 max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev,
                                 offload=offload)
        rm = RequestManager(engine, decode_horizon=16, pipelined=True)
        try:
            reqs[name], out[name] = _served(rm, prompts, 64, spec.vocab_size,
                                            f"offload (a) {name}", replayed=not offload)
        finally:
            rm.close()
        _log_served(f"(a) LLaMA-2-7B INT8 {name}", out[name], card)
        del engine, rm
        gc.collect()
        torch.cuda.empty_cache()
    for k in ("qmm_int8", "decode_attention", "flash_prefill"):
        require(out["offload"]["launches"][k] > 0, f"offload (a): {k} was never launched")
    same = [a.output_tokens == b.output_tokens for a, b in zip(reqs["resident"], reqs["offload"])]
    require(all(same), f"offload (a): tokens differ from the resident run's: {same}")
    log(f"  (a) all {len(same)} x 64 tokens equal to the resident run's; decode "
        f"{out['offload']['decode_tok_s']:.2f} tok/s offload against "
        f"{out['resident']['decode_tok_s']:.2f} resident [{card}]")
    return out


def offload_bitwise_run(card: str) -> dict:
    """Run (b): Mixtral-8x7B bf16 at full width, 4 layers, resident against
    offload: the prefill logits and 16 decode steps' logits bitwise."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    dev = torch.device("cuda")
    spec = mixtral_spec(4)
    params = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0),
                                    torch.bfloat16, dev, host_layers=True)
    prompts = _prompts(spec.vocab_size)
    logits, walls = {}, {}
    for offload in (False, True):
        engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                                 cache_dtype=torch.bfloat16, device=dev, offload=offload)
        name = "offload" if offload else "resident"
        _stepped_logits(engine, prompts, 1)  # warm-up: the timed run below is not the first
        logits[name], walls[name] = _stepped_logits(engine, prompts, OFFLOAD_NEW_TOKENS)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    del params
    g = logits["offload"]
    require(bool(torch.isfinite(g).all()) and g.shape == (OFFLOAD_NEW_TOKENS + 1, 8,
                                                         spec.vocab_size),
            f"offload (b): logits not finite or shaped {tuple(g.shape)}")
    equal = torch.equal(g, logits["resident"])
    require(equal, "offload (b): logits differ from the resident run's, max|diff| "
            f"{(g - logits['resident']).abs().max().item()}")
    out = dict(bitwise=equal, steps=OFFLOAD_NEW_TOKENS, walls_s=walls,
               layers=spec.num_layers)
    log(f"  (b) Mixtral-8x7B bf16, 4 layers: prefill and {OFFLOAD_NEW_TOKENS} decode steps' "
        f"logits bitwise equal to resident; prefill {walls['offload'][0]:.3f} s offload against "
        f"{walls['resident'][0]:.3f} s resident, a decode step {walls['offload'][1]:.3f} against "
        f"{walls['resident'][1]:.3f} s [{card}]")
    return out


def _staged_only(store):
    """A view of an engine's ``LayerStore`` (a subclass sharing its slots,
    stream and events) whose forwards read the two staged slots, layer i
    from slot i % 2, and copy nothing: the offload path's compute alone."""
    import torch

    from flexflow_tpu_torch.models.layer_store import LayerStore

    class StagedOnly(LayerStore):
        def __init__(self, store):
            self.__dict__.update(store.__dict__)

        def acquire(self, i):
            torch.cuda.current_stream(self.device).wait_event(self._copied[i % 2])
            return dict(self._views[i % 2])

        def release(self, i):
            pass

    return StagedOnly(store)


def offload_mixtral_run(card: str) -> dict:
    """Run (c): Mixtral-8x7B bf16 at full width, ``OFFLOAD_LAYERS`` deep,
    offload only: the served run (horizon 1, not pipelined, so each fetch
    closes a step), the copy-alone and compute-alone times, the host rate."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.models import layer_store as offload_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager

    dev = torch.device("cuda")
    spec = mixtral_spec(OFFLOAD_LAYERS)
    out = {"layers": spec.num_layers, "mem_available_gib_before": _mem_available_gib(),
           "rss_gib_before": _rss_gib()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pinned0, pin0, t0 = offload_lib.pinned_bytes, offload_lib.pin_seconds, time.perf_counter()
    params = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0),
                                    torch.bfloat16, dev, host_layers=True)
    torch.cuda.synchronize()
    out.update(init_s=time.perf_counter() - t0, pin_s=offload_lib.pin_seconds - pin0,
               init_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                             max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev,
                             offload=True)
    del params
    gc.collect()
    store = engine.params["layers"]
    out["stack_gib"] = store.layer_bytes * spec.num_layers / 2**30
    out["pinned_gib"] = (offload_lib.pinned_bytes - pinned0) / 2**30
    require(offload_lib.pinned_bytes - pinned0 == store.layer_bytes * spec.num_layers,
            f"offload (c): {out['pinned_gib']:.2f} GiB pinned for {out['stack_gib']:.2f} GiB "
            f"of layers: the stack is pinned more than once")
    out["layer_gb"] = store.layer_bytes / 1e9
    out["mem_available_gib_after"], out["rss_gib_after"] = _mem_available_gib(), _rss_gib()
    log(f"  (c) Mixtral-8x7B bf16, {spec.num_layers} layers: {out['stack_gib']:.2f} GiB of layers "
        f"pinned (one copy), init {out['init_s']:.1f} s (cudaHostRegister {out['pin_s']:.1f} s), init peak "
        f"{out['init_peak_gib']:.2f} GiB on the card; MemAvailable "
        f"{out['mem_available_gib_before']:.1f} -> {out['mem_available_gib_after']:.1f} GiB, "
        f"this process's RSS {out['rss_gib_before']:.1f} -> {out['rss_gib_after']:.1f} GiB "
        f"[{card}]")
    out["h2d_gbps"] = _h2d_gbps()
    prompts = _prompts(spec.vocab_size)
    rm = RequestManager(engine, decode_horizon=1, pipelined=False)
    try:
        reqs, served, stamps = _served_stamped(rm, prompts, OFFLOAD_NEW_TOKENS,
                                               spec.vocab_size, "offload (c)")
    finally:
        rm.close()
    out.update(served)
    # the served run's fetches: the admission's first tokens, then one a step
    t_reg = min(r.profile.start_time for r in reqs)
    marks = [s for s in stamps if s >= t_reg]
    out["prefill_wall_s"] = marks[0] - t_reg
    out["step_walls_s"] = list(np.diff(marks))
    require(len(out["step_walls_s"]) == OFFLOAD_NEW_TOKENS - 1,
            f"offload (c): {len(out['step_walls_s'])} decode steps timed")
    for k in ("decode_attention", "flash_prefill"):
        require(served["launches"][k] > 0, f"offload (c): {k} was never launched")
    # the stream alone: every layer copied once, no compute
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for layer in range(spec.num_layers):
        store._copy(layer % 2, layer)
    store._stream.synchronize()
    out["copy_alone_s"] = time.perf_counter() - t0
    store.restart(0)
    # the compute alone: a prefill and a decode step on the staged slots
    logits, walls = _stepped_logits(engine, prompts, 1, layers=_staged_only(store))
    out["compute_alone_prefill_s"], out["compute_alone_step_s"] = walls
    require(bool(torch.isfinite(logits).all()), "offload (c): compute-alone logits not finite")
    stream_s = store.layer_bytes * spec.num_layers / (out["h2d_gbps"] * 1e9)
    out["stream_s_at_h2d_rate"] = stream_s
    stack_bytes = store.layer_bytes * spec.num_layers
    require(served["peak_mem_gib"] * 2**30 < OFFLOAD_PEAK_SHARE * stack_bytes,
            f"offload (c): peak {served['peak_mem_gib']:.2f} GiB is not below "
            f"{OFFLOAD_PEAK_SHARE:.0%} of the layers' {stack_bytes / 2**30:.2f} GiB")
    overlap_limit = out["copy_alone_s"] + out["compute_alone_prefill_s"]
    require(out["mean_ttft_ms"] / 1e3 < overlap_limit,
            f"offload (c): prefill (mean TTFT) {out['mean_ttft_ms'] / 1e3:.3f} s is not below "
            f"copy-alone + compute-alone {overlap_limit:.3f} s: the copies do not overlap")
    steps = out["step_walls_s"]
    log(f"  (c) host->device {out['h2d_gbps']:.2f} GB/s (1 GiB from pinned memory); layers "
        f"{store.layer_bytes * spec.num_layers / 1e9:.2f} GB: {stream_s:.3f} s at that rate; "
        f"copy alone {out['copy_alone_s']:.3f} s; compute alone: prefill "
        f"{out['compute_alone_prefill_s']:.3f} s, a decode step "
        f"{out['compute_alone_step_s']:.3f} s [{card}]")
    log(f"  (c) served: TTFT mean {out['mean_ttft_ms']:.1f} ms (prefill wall "
        f"{out['prefill_wall_s']:.3f} s), decode steps {min(steps):.3f}-{max(steps):.3f} s "
        f"(mean {float(np.mean(steps)):.3f}), {out['decode_tok_s']:.2f} tok/s, peak "
        f"{out['peak_mem_gib']:.2f} GiB allocated ({out['peak_mem_gib'] * 2**30 / stack_bytes:.1%} "
        f"of the layers) [{card}]")
    log(f"  (c) decode step walls (s): {json.dumps([round(s, 4) for s in steps])}")
    del rm, engine, store
    gc.collect()
    torch.cuda.empty_cache()
    # the pinned layers leave the process with the engine (its RSS; the
    # machine's MemAvailable follows some seconds later)
    out["rss_gib_freed"] = _rss_gib()
    require(out["rss_gib_after"] - out["rss_gib_freed"] > 0.95 * out["stack_gib"],
            f"offload (c): RSS {out['rss_gib_freed']:.1f} GiB after the engine is freed, "
            f"{out['rss_gib_after']:.1f} with its {out['stack_gib']:.1f} GiB of layers pinned")
    log(f"  (c) engine freed: this process's RSS back to {out['rss_gib_freed']:.1f} GiB")
    return out


def offload_phase(card: str) -> dict:
    """CPU offload: run (a) LLaMA-2-7B INT8 resident against offload, (b)
    Mixtral-8x7B bf16 4 layers bitwise, (c) Mixtral-8x7B bf16 served from
    host memory at ``OFFLOAD_LAYERS`` layers."""
    out = {"llama": offload_llama_run(card), "bitwise": offload_bitwise_run(card),
           "mixtral": offload_mixtral_run(card)}
    out["card"] = card
    return out


def _lora_adapters(spec, n: int, device, seed: int, targets=LORA_TARGETS,
                   dtype: str = "bfloat16", lr: float = 1e-3):
    """``n`` LoRA adapters at rank 16, alpha 32 on ``targets`` (default the
    seven projections; SGD at ``lr`` when finetuned), in ``dtype``, A and B
    both drawn from one seeded generator (B non-zero, so every adapter
    acts). Returns (stacks, config)."""
    import torch

    from flexflow_tpu_torch.peft.lora import LoraConfig, init_lora_params

    cfg = LoraConfig(rank=16, alpha=32.0, target_modules=targets, learning_rate=lr)
    gen = torch.Generator(device=device).manual_seed(seed)
    lora = init_lora_params(spec, cfg, n, gen, getattr(torch, dtype), device)
    for ab in lora.values():
        ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen, device=device) * LORA_B_STD)
    return lora, cfg


def crosscheck_lora(steps: int = 8) -> dict:
    """2 layers at full 7B width, INT8, 4 adapters (seeds 1 and 2): a
    prefill of 4 requests routed [0, 3, -1, 1] and ``steps`` decode steps,
    teacher-forced by the GPU's LoRA tokens, through the kernels on the GPU
    with and without the adapters and through the plain versions on the CPU
    with them."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.peft.lora import lora_scaling, route_lora
    from flexflow_tpu_torch.serving.engine import _params_to
    from flexflow_tpu_torch.specs import ModelSpec

    t0 = time.perf_counter()
    dev, host = torch.device("cuda"), torch.device("cpu")
    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": 2})
    gpu = decoder.fuse_qkv_params(spec, _quant_params(spec, 1, dev))
    cpu = _params_to(gpu, host)
    lora, cfg = _lora_adapters(spec, 4, dev, 2)
    ids = [0, 3, -1, 1]
    scale = lora_scaling(cfg)
    sides = {"gpu": (dev, gpu, route_lora(lora)),
             "cpu": (host, cpu, route_lora(_params_to(lora, host))),
             "base": (dev, gpu, None)}
    rng = np.random.default_rng(4)
    lens = np.array([20, 13, 27, 9], np.int32)
    nb, t, s_max = len(lens), 32, 64
    toks = np.zeros((nb, t), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(3, spec.vocab_size, n)

    def routing(name):
        d, _, routed = sides[name]
        return {} if routed is None else dict(
            lora=routed, adapter_ids=torch.tensor(ids, device=d), lora_scale=scale)

    caches, logits = {}, {}
    for name, (d, params, _) in sides.items():
        cache = decoder.init_kv_cache(spec, nb, s_max, torch.bfloat16, d)
        ln = torch.as_tensor(lens, device=d)
        with torch.no_grad():
            lg, (k, v) = decoder.forward(
                spec, params, torch.as_tensor(toks, device=d),
                torch.arange(t, dtype=torch.int32, device=d)[None].expand(nb, t), lengths=ln,
                flash=True, return_kv=True, logits_at=ln - 1, **routing(name))
        decoder.commit_kv_windows(cache.k, cache.v, k.permute(0, 1, 3, 2, 4),
                                  v.permute(0, 1, 3, 2, 4), [0] * nb)
        caches[name], logits[name] = cache, [lg.float().cpu()]
    cur = logits["gpu"][0].argmax(-1)
    for i in range(steps):
        for name, (d, params, _) in sides.items():
            with torch.no_grad():
                lg, _ = decoder.forward_cached(
                    spec, params, cur[:, None].to(d), caches[name],
                    torch.as_tensor(lens + i, device=d), write_start=lens + i, **routing(name))
            logits[name].append(lg[:, 0].float().cpu())
        cur = logits["gpu"][-1].argmax(-1)
    g, c, b = (torch.stack(logits[n]) for n in ("gpu", "cpu", "base"))  # [steps + 1, B, V]
    require(g.shape == (steps + 1, nb, spec.vocab_size), f"logits shaped {tuple(g.shape)}")
    out = logits_rule(g, c, slice(None), "lora cross-check")
    acts = [(g[:, r] - b[:, r]).abs().max().item() for r in range(nb)]
    for r, a in enumerate(ids):
        if a >= 0:
            require(acts[r] > 10 * out["max_abs_err"],
                    f"lora cross-check: adapter {a}'s row moves the logits by {acts[r]:.4g}, not "
                    f"above 10 x the GPU-CPU error {out['max_abs_err']:.4g}")
        else:
            require(torch.equal(g[:, r], b[:, r]),
                    "lora cross-check: the -1 row's logits differ from the no-LoRA forward's")
    out.update(adapter_ids=ids, lora_minus_base=acts, seconds=time.perf_counter() - t0)
    log(f"  cross-check LoRA (2 layers, 4 adapters, rows {ids}, {steps} steps): logits max|err| "
        f"{out['max_abs_err']:.4g} (tol {out['tol']:.4g}); greedy tokens equal "
        f"{out['tokens_equal']}/{out['tokens']} ({out['decided']} beyond the error margin); "
        f"max|LoRA - base| per row {[f'{a:.4g}' for a in acts]} (the -1 row bitwise equal); "
        f"{out['seconds']:.1f} s")
    del gpu, cpu, caches, sides, lora
    torch.cuda.empty_cache()
    return out


def lora_trace(engine, prompts, adapters) -> dict:
    """One replayed 16-step decode horizon and one batched prefill of
    ``prompts`` on ``engine``, the 8 rows routed to ``adapters`` (None: no
    adapter), traced (``_trace``) with every kernel's device time kept
    under ``kernels_ms``; keyed by "decode_horizon_16" and "prefill_8x1024"."""
    import numpy as np

    from flexflow_tpu_torch.ops.sampling import SamplingConfig

    b = engine.max_requests
    greedy = SamplingConfig(np.zeros(b, np.float32), np.ones(b, np.float32),
                            np.zeros(b, np.int32))
    lens = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros(b, np.int32)
    tag = "lora" if adapters else "base"
    runs = _trace([
        (f"{tag} decode_horizon_16",
         lambda: engine.decode_horizon_async(lens, toks, 0, greedy, 16, adapter_ids=adapters), 16),
        (f"{tag} prefill_8x1024",
         lambda: engine.prefill_batch_to_slots_async(prompts, list(range(b)), 0, greedy,
                                                     adapter_ids=adapters), 1),
    ], keep_all=True)
    return {k.split(" ")[1]: v for k, v in runs.items()}


def lora_phase(card: str, with_profile: bool) -> dict:
    """LoRA serving at full LLaMA-2-7B width, INT8: the cross-check, the
    no-adapter run, the adapter run over the same weight tensors, the -1
    requests against the no-adapter run, one replayed horizon against the
    uncaptured body."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    out = {"crosscheck": crosscheck_lora()}
    dev = torch.device("cuda")
    spec = ModelSpec(**LLAMA2_7B)
    kw = dict(max_requests_per_batch=8, max_seq_len=1024, max_tokens_per_batch=0,
              cache_dtype=torch.bfloat16, device=dev)
    base = InferenceEngine(spec, _quant_params(spec, 0, dev), **kw)
    rm = RequestManager(base, decode_horizon=16, pipelined=True)
    prompts = _prompts(spec.vocab_size)
    try:
        base_reqs, out["base"] = _served(rm, prompts, 64, spec.vocab_size, "lora base")
        if with_profile:
            log("[profile] one decode horizon and one batched prefill without adapters")
            out["base"]["profile"] = lora_trace(base, prompts, None)
    finally:
        rm.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lora, cfg = _lora_adapters(spec, 4, dev, 0)
    torch.cuda.synchronize()
    out["adapters_build_s"] = time.perf_counter() - t0
    out["adapters_bytes"] = sum(x.numel() * x.element_size() for ab in lora.values()
                                for x in ab.values())
    # the base engine's fused weight tensors, shared: fusing them again is a no-op
    engine = InferenceEngine(spec, base.params, lora=lora, lora_config=cfg, **kw)
    out["routed_bytes"] = sum(x.numel() * x.element_size()
                              for part in (engine.lora.a, engine.lora.b) for x in part.values())
    del lora, base, rm
    torch.cuda.empty_cache()
    log(f"  adapters: 4 x rank 16 on {len(LORA_TARGETS)} projections x {spec.num_layers} layers, "
        f"{out['adapters_bytes'] / 2**20:.1f} MiB in bf16, built in "
        f"{out['adapters_build_s']:.3f} s; the engine's routing layout (float32) "
        f"{out['routed_bytes'] / 2**20:.1f} MiB [{card}]")
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    try:
        reqs, served = _served(rm, prompts, 64, spec.vocab_size, "lora", adapters=LORA_IDS)
        out.update(served)
        for i, a in enumerate(LORA_IDS):
            if a < 0:
                require(reqs[i].output_tokens == base_reqs[i].output_tokens,
                        f"lora: request {i} (no adapter) differs from the no-adapter run's tokens")
        out["adapter_requests_changed"] = sum(
            reqs[i].output_tokens != base_reqs[i].output_tokens
            for i, a in enumerate(LORA_IDS) if a >= 0)
        require(out["adapter_requests_changed"] > 0,
                "lora: every adapter request gave the no-adapter run's tokens")
        lens = np.array([len(p) for p in prompts], np.int32)
        toks = np.array([(r.output_tokens[0] + 1) % spec.vocab_size for r in reqs], np.int32)
        _replay_check("lora decode horizon (16 steps, 8 slots)",
                      lambda replay: [engine.greedy_horizon_async(lens, toks, 16, replay=replay,
                                                                  adapter_ids=LORA_IDS)],
                      list(engine.cache))
        if with_profile:
            log("[profile] one decode horizon and one batched prefill with the adapters")
            out["profile"] = prof = lora_trace(engine, prompts, LORA_IDS)
            for what, run in prof.items():
                base_run = out["base"]["profile"][what]
                grown = {k: v - base_run["kernels_ms"].get(k, 0.0)
                         for k, v in run.pop("kernels_ms").items()}
                base_run.pop("kernels_ms")
                lora_ms = run["device_busy_ms"] - base_run["device_busy_ms"]
                run.update(lora_device_ms=lora_ms,
                           lora_device_share=lora_ms / run["device_busy_ms"],
                           grown_kernels_ms=dict(sorted(grown.items(), key=lambda kv: -kv[1])[:8]))
                log(f"  the adapters' device time in the {what}: {lora_ms:.2f} ms of "
                    f"{run['device_busy_ms']:.2f} ms busy ({100 * run['lora_device_share']:.1f}%) "
                    f"[{card}]; the kernels that grew most:")
                for k, v in run["grown_kernels_ms"].items():
                    log(f"    {v:9.3f} ms  {k[:100]}")
    finally:
        rm.close()
    for k in ("qmm_int8", "decode_attention", "flash_prefill"):
        require(out["launches"][k] > 0, f"{k} was never launched while serving with adapters")
    out["card"] = card
    _log_served("lora base (no adapters)", out["base"], card)
    _log_served("lora (4 adapters)", out, card)
    log(f"  lora: requests without an adapter equal the no-adapter run's tokens; "
        f"{out['adapter_requests_changed']} of 6 adapter requests changed tokens; LoRA / base "
        f"decode tok/s {out['decode_tok_s'] / out['base']['decode_tok_s']:.3f} [{card}]")
    del engine, rm
    torch.cuda.empty_cache()
    return out


def _quant_matmul_in_x_dtype(x, qa, *, layer=None, expert=None, out_dtype=None):
    """A second plain quant-matmul (stacked carriers, no experts): the plain
    dequantized weight multiplied in x's dtype by ``torch.matmul`` (cuBLAS,
    f32 accumulation) instead of in f32. Both are right; their difference
    is the noise floor of a bf16 forward."""
    import torch

    from flexflow_tpu_torch.ops.kernels import quant_matmul as qm

    del expert
    w = qm.dequant_weight(qa.q, qa.scale, qa.offset, qa.bits, qa.group_size, qa.d_rest, layer,
                          x.dtype)
    lead = x.shape[: x.dim() - qa.contract_dims]
    out = torch.matmul(x.reshape(-1, qa.d_contract), w).to(out_dtype or x.dtype)
    return out.reshape(*lead, *qa.shape[qa.batch_dims + qa.contract_dims:])


@contextlib.contextmanager
def _plain_quant_matmul(fn=None):
    """The decoder's quant-matmul calls go to a plain version (default
    ``quant_matmul_plain``; autograd through its torch ops): the yardstick
    of the kernels and of ``QuantMatmulFn``'s backward."""
    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.ops.kernels import quant_matmul as qm

    kernel = decoder.quant_matmul
    decoder.quant_matmul = fn or qm.quant_matmul_plain
    try:
        yield
    finally:
        decoder.quant_matmul = kernel


def _finetune_data(vocab_size: int, seed: int = 6):
    """FT_SEQS seeded sequences of FT_LEN next-token pairs ([1, T] each)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(FT_SEQS):
        ids = rng.integers(3, vocab_size, FT_LEN + 1).astype(np.int32)
        out.append((ids[None, :-1], ids[None, 1:]))
    return out


def _lora_grads(session, engine, tokens, labels, plain=None):
    """One finetuning step's forward and backward with no update: (loss, the
    session slot's gradients {(module, "a" | "b"): [L, ...]}); through the
    kernels, or with ``plain`` (True, or a plain quant-matmul function)
    through a plain version."""
    with (_plain_quant_matmul(None if plain is True else plain) if plain
          else contextlib.nullcontext()):
        loss = session.loss(engine, tokens, labels)
        loss.backward()
    grads = {}
    for mod, ab in session.params.items():
        for k, p in ab.items():
            grads[(mod, k)] = p.grad.detach().float().clone()
            p.grad = None
    return float(loss.detach()), grads


def _grad_rule(got, want, what: str, min_cos: float, max_rel: float) -> dict:
    """Per tensor (module, a or b, layer): cosine and relative L2 distance of
    ``got`` to ``want``; every tensor non-zero, within both limits."""
    rows = []
    for key, w in want.items():
        g = got[key].to(w.device)
        for layer in range(w.shape[0]):
            gl, wl = g[layer].flatten().double(), w[layer].flatten().double()
            wn = wl.norm().item()
            require(wn > 0 and gl.norm().item() > 0,
                    f"{what}: {key} layer {layer} has a zero gradient")
            cos = (gl @ wl).item() / (gl.norm().item() * wn)
            rows.append((f"{key[0]}.{key[1]}", layer, cos, (gl - wl).norm().item() / wn))
    bad = [r for r in rows if r[2] < min_cos or r[3] > max_rel]
    require(not bad, f"{what}: tensors off the limits (cosine >= {min_cos}, rel L2 <= "
                     f"{max_rel}): {bad[:6]}")
    out = dict(tensors=len(rows), min_cosine=min(r[2] for r in rows),
               max_rel_l2=max(r[3] for r in rows),
               layer0={name: (cos, rel) for name, layer, cos, rel in rows if layer == 0})
    log(f"  {what}: {len(rows)} tensors, min cosine {out['min_cosine']:.6f}, max rel L2 "
        f"{out['max_rel_l2']:.3g}; layer 0 (cosine, rel L2) "
        f"{ {k: (round(c, 6), float(f'{r:.3g}')) for k, (c, r) in out['layer0'].items()} }")
    return out


def crosscheck_finetune() -> dict:
    """2 layers at full 7B width, INT8 with f32 activations, two adapter
    slots (A and B drawn): one finetuning step's loss and slot-1 gradients
    through the kernels on the GPU against the plain versions on the CPU,
    each tensor within 1e-3 (relative L2)."""
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.quant import quantize_params
    from flexflow_tpu_torch.serving.engine import InferenceEngine, _params_to
    from flexflow_tpu_torch.specs import ModelSpec

    dev, host = torch.device("cuda"), torch.device("cpu")
    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": 2})
    gen = torch.Generator(device=dev).manual_seed(1)
    params = quantize_params(spec, params_lib.init_params(spec, gen, torch.float32, dev),
                             bits=8, group_size=128, compute_dtype=torch.float32)
    params = decoder.fuse_qkv_params(spec, params)
    lora, cfg = _lora_adapters(spec, 2, dev, 3, FT_TARGETS, "float32", FT_LR)
    tokens, labels = (a[:, :64] for a in _finetune_data(spec.vocab_size)[0])
    out = {}
    for name, d in (("gpu", dev), ("cpu", host)):
        engine = InferenceEngine(spec, _params_to(params, d), max_requests_per_batch=1,
                                 max_seq_len=64, cache_dtype=torch.float32, device=d,
                                 lora=_params_to(lora, d), lora_config=cfg)
        out[name] = _lora_grads(FinetuneSession(spec, cfg, 1, [(tokens, labels)]), engine,
                                tokens, labels)
        del engine
    (lg, gg), (lc, gc) = out["gpu"], out["cpu"]
    require(abs(lg - lc) <= 1e-3 * abs(lc), f"finetune cross-check loss {lg} vs CPU {lc}")
    res = _grad_rule(gg, gc, "finetune cross-check (2 layers, f32, GPU kernels vs CPU plain)",
                     0.999, 1e-3)
    res.update(loss_gpu=lg, loss_cpu=lc)
    del params, lora, out
    torch.cuda.empty_cache()
    return res


def _f32_tree(params):
    """The served tree with f32 activations: quantized carriers shared (their
    compute dtype f32), other leaves cast."""
    import torch

    from flexflow_tpu_torch.quant.weight_only import QuantizedArray

    if isinstance(params, dict):
        return {k: _f32_tree(v) for k, v in params.items()}
    if isinstance(params, QuantizedArray):
        return dataclasses.replace(params, dtype=torch.float32)
    return params.float() if isinstance(params, torch.Tensor) else params


def _dx_rows(engine, card: str) -> dict:
    """QuantMatmulFn's backward at a finetune step's FT_LEN rows on each of
    the engine's quantized carriers (layer 0; the lm_head): the plain
    dequant of one carrier and the bf16 torch.matmul, device time beside its
    bound (the carrier, dy and dx moved once; 2 m D F operations)."""
    import torch

    from flexflow_tpu_torch.ops.kernels import quant_matmul as qm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    layers = engine.params["layers"]
    carriers = [(k, layers[k], 0, engine.spec.num_layers) for k in ("wqkv", "wo", "wgu", "wd")]
    carriers.append(("lm_head", engine.params["lm_head"], None, 1))
    out, total = {}, 0.0
    for name, qa, layer, per_step in carriers:
        d, f = qa.d_contract, qa.d_rest
        dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        dy = torch.randn((FT_LEN, f), generator=gen, device=dev).to(dtype)

        def dx():
            w = qm.dequant_weight(qa.q, qa.scale, qa.offset, qa.bits, qa.group_size, f, layer,
                                  torch.bfloat16)
            return torch.matmul(dy.to(torch.bfloat16), w.t())

        ms = time_ms(dx, 10)
        nbytes = dy.numel() * dy.element_size() + _weight_bytes(8, d, qa.q.shape[-1],
                                                               qa.group_size) + FT_LEN * d * 2
        b_ms, b_by = bound(nbytes, 2.0 * FT_LEN * d * f, PEAK_BF16_FLOPS)
        out[name] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, per_step=per_step)
        total += ms * per_step
        log(f"  backward dx {name} {d}x{f} m={FT_LEN} (dequant + bf16 torch.matmul, not a TPU "
            f"kernel): {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {per_step} a step [{card}]")
    out["per_step_ms"] = total
    return out


def finetune_phase(card: str) -> dict:
    """Co-scheduled LoRA finetuning at full LLaMA-2-7B depth and width, INT8:
    (a) one step's slot gradients through the kernels and QuantMatmulFn
    against the plain quant-matmul on the card, with f32 activations
    (cosine >= 0.999, relative L2 <= 3e-2 per tensor) and with bf16 ones
    (within 1.5x the floor between two plain versions), and a 2-layer f32
    check against the CPU; (b) the 8 prompts routed FT_IDS served with a session
    training slot 1: tokens equal the run without it, every greedy step a
    replay, each sequence's loss falls over the epochs; (c) slot 1 served after training: tokens differ
    from before it, and a replayed horizon equals the uncaptured body on the
    updated adapter; (d) slot 1 exported and loaded into a fresh engine's
    slot bitwise. Prints the step's forward, backward (the dequant + matmul
    part apart) and update times, decode tok/s with and without the session
    and peak memory."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.ops.kernels import quant_matmul as qm
    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.peft.lora import (export_hf_adapter, init_lora_params,
                                             load_hf_adapter_into_slot, unroute_lora)
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    out = {"crosscheck": crosscheck_finetune()}
    dev = torch.device("cuda")
    spec = ModelSpec(**LLAMA2_7B)
    lora, cfg = _lora_adapters(spec, 2, dev, 0, FT_TARGETS, lr=FT_LR)
    engine = InferenceEngine(spec, _quant_params(spec, 0, dev), max_requests_per_batch=8,
                             max_seq_len=1024, max_tokens_per_batch=0,
                             cache_dtype=torch.bfloat16, device=dev, lora=lora, lora_config=cfg)
    del lora
    data = _finetune_data(spec.vocab_size)
    r, n_layers = cfg.rank, spec.num_layers

    # (a) one step's gradients through the kernels against the plain path,
    # layer 0 included: with f32 activations over the same carriers (the
    # f32 kernel regime) at fixed limits; with the served bf16 activations
    # against the floor that a second plain version sets (two right bf16
    # forwards part by their roundings, amplified over 32 layers)
    f32 = InferenceEngine(spec, _f32_tree(engine.params), max_requests_per_batch=1,
                          max_seq_len=16, cache_dtype=torch.float32, device=dev,
                          lora=unroute_lora(engine.lora), lora_config=cfg)
    probe = FinetuneSession(spec, cfg, 1, data)
    loss_k, grads_k = _lora_grads(probe, f32, *data[0])
    loss_p, grads_p = _lora_grads(FinetuneSession(spec, cfg, 1, data), f32, *data[0], plain=True)
    require(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
            f"finetune: f32 loss through the kernels {loss_k} vs the plain path {loss_p}")
    out["grads_f32"] = _grad_rule(grads_k, grads_p, "finetune gradients (32 layers, f32 "
                                  "activations, kernels + QuantMatmulFn vs plain quant-matmul)",
                                  0.999, 3e-2)
    del f32, probe, grads_k, grads_p
    torch.cuda.empty_cache()
    probe = FinetuneSession(spec, cfg, 1, data)
    launches, calls = qm.LAUNCHES, qm.BACKWARD_CALLS
    loss_k, grads_k = _lora_grads(probe, engine, *data[0])
    out["grad_launches"] = dict(qmm_int8=qm.LAUNCHES - launches,
                                backward=qm.BACKWARD_CALLS - calls)
    # every base projection and the lm_head launch K1/K3 forward; each passes
    # its gradient back through QuantMatmulFn but layer 0's wqkv, whose input
    # (the embedding) trains nothing
    want = dict(qmm_int8=4 * n_layers + 1, backward=4 * n_layers)
    require(out["grad_launches"] == want,
            f"finetune: a step launched {out['grad_launches']}, expected {want}")
    loss_p, grads_p = _lora_grads(probe, engine, *data[0], plain=True)
    loss_b, grads_b = _lora_grads(probe, engine, *data[0], plain=_quant_matmul_in_x_dtype)
    torch.cuda.empty_cache()
    floor = _grad_rule(grads_b, grads_p, "bf16 floor: plain in bf16 vs plain in f32 products "
                       "(32 layers, both right)", 0.99, 1.0)
    k_cos, k_rel = 1 - 1.5 * (1 - floor["min_cosine"]), 1.5 * floor["max_rel_l2"]
    out["grads"] = _grad_rule(grads_k, grads_p, "finetune gradients (32 layers, bf16, kernels + "
                              "QuantMatmulFn vs plain quant-matmul; limits 1.5x the floor)",
                              k_cos, k_rel)
    require(abs(loss_k - loss_p) <= 2 * abs(loss_b - loss_p) + 1e-6 * abs(loss_p),
            f"finetune: bf16 loss through the kernels {loss_k} vs the plain path {loss_p} "
            f"(the second plain version {loss_b})")
    out["grads"].update(loss_kernels=loss_k, loss_plain=loss_p, loss_plain_bf16=loss_b,
                        floor=floor)
    del grads_k, grads_p, grads_b, probe

    # (b) served with and without a co-scheduled session
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    prompts = _prompts(spec.vocab_size)
    routed_ptrs = [t.data_ptr() for part in (engine.lora.a, engine.lora.b) for t in part.values()]
    slot0 = [t.clone() for t in (*(a[..., :r] for a in engine.lora.a.values()),
                                 *(b[:, :r] for b in engine.lora.b.values()))]
    try:
        base_reqs, out["base"] = _served(rm, prompts, 64, spec.vocab_size, "finetune base",
                                         adapters=FT_IDS)
        pre_reqs, _ = _served(rm, prompts, 64, spec.vocab_size, "slot 1 before training",
                              adapters=[1] * 8)
        session = FinetuneSession(spec, cfg, 1, data, epochs=FT_STEPS // FT_SEQS)
        reqs, served = _served(rm, prompts, 64, spec.vocab_size, "finetune co-scheduled",
                               adapters=FT_IDS, session=session)
        out.update(served)
        require([q.output_tokens for q in reqs] == [q.output_tokens for q in base_reqs],
                "finetune: the co-scheduled run's tokens differ from the run without a session")
        losses = session.losses
        out["losses"] = losses
        # step i trains sequence i % FT_SEQS: each sequence's loss must fall
        # from the first epoch to the last (the first and the last step see
        # different sequences)
        require(len(losses) == FT_STEPS and all(
            losses[-FT_SEQS + i] < losses[i] for i in range(FT_SEQS)),
            f"finetune: {len(losses)} steps, losses {losses}")
        require(all(torch.equal(a, b) for a, b in zip(
            slot0, (*(a[..., :r] for a in engine.lora.a.values()),
                    *(b[:, :r] for b in engine.lora.b.values())))),
                "finetune: slot 0 changed")
        require(routed_ptrs == [t.data_ptr() for part in (engine.lora.a, engine.lora.b)
                                for t in part.values()],
                "finetune: the routed adapters were reallocated, not updated in place")
        log(f"  finetune losses over {FT_STEPS} steps: {[round(v, 4) for v in losses]}; by "
            f"sequence, epoch 1 -> {FT_STEPS // FT_SEQS}: "
            f"{[(round(losses[i], 4), round(losses[-FT_SEQS + i], 4)) for i in range(FT_SEQS)]}")

        # the step's parts, timed on the device (4 more steps of slot 1)
        timer = FinetuneSession(spec, cfg, 1, data)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        parts = []
        for i in range(1 + FT_SEQS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            loss = timer.loss(engine, *data[i % FT_SEQS])
            ev[1].record()
            loss.backward()
            ev[2].record()
            timer.update()
            ev[3].record()
            parts.append(ev)
        torch.cuda.synchronize()
        step = {k: float(np.mean([e[j].elapsed_time(e[j + 1]) for e in parts[1:]]))
                for j, k in enumerate(("forward_ms", "backward_ms", "update_ms"))}
        step["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        step["dx"] = _dx_rows(engine, card)
        out["step"] = step
        log(f"  finetune step (1 x {FT_LEN} tokens, device time, mean of {FT_SEQS}): forward "
            f"{step['forward_ms']:.2f} ms, backward {step['backward_ms']:.2f} ms (of it the "
            f"dequant + matmul dx, timed alone: {step['dx']['per_step_ms']:.2f} ms), update "
            f"{step['update_ms']:.3f} ms; peak memory {step['peak_mem_gib']:.2f} GiB [{card}]")

        # (c) the trained slot, served and replayed
        post_reqs, out["after"] = _served(rm, prompts, 64, spec.vocab_size,
                                          "slot 1 after training", adapters=[1] * 8)
        out["slot1_requests_changed"] = sum(a.output_tokens != b.output_tokens
                                            for a, b in zip(post_reqs, pre_reqs))
        require(out["slot1_requests_changed"] > 0,
                "finetune: slot 1 serves the same tokens after training as before")
        lens = np.array([len(p) for p in prompts], np.int32)
        toks = np.array([(q.output_tokens[0] + 1) % spec.vocab_size for q in post_reqs], np.int32)
        _replay_check("trained slot-1 decode horizon (16 steps, 8 slots)",
                      lambda replay: [engine.greedy_horizon_async(lens, toks, 16, replay=replay,
                                                                  adapter_ids=[1] * 8)],
                      list(engine.cache))
    finally:
        rm.close()

    # (d) export slot 1, load it into a fresh engine's slot 0
    with tempfile.TemporaryDirectory(prefix=".finetune_export_",
                                     dir=os.path.dirname(os.path.abspath(__file__))) as d:
        export_hf_adapter(d, spec, unroute_lora(engine.lora), 1, cfg)
        gen = torch.Generator(device=dev).manual_seed(9)
        fresh = init_lora_params(spec, cfg, 2, gen, torch.float32, dev)
        load_hf_adapter_into_slot(d, spec, fresh, 0, cfg)
    other = InferenceEngine(spec, engine.params, max_requests_per_batch=1, max_seq_len=64,
                            cache_dtype=torch.bfloat16, device=dev, lora=fresh, lora_config=cfg)
    require(all(torch.equal(other.lora.a[m][..., :r], engine.lora.a[m][..., r:2 * r])
                and torch.equal(other.lora.b[m][:, :r], engine.lora.b[m][:, r:2 * r])
                for m in engine.lora.a),
            "finetune: the exported slot, loaded into a fresh engine, differs from the trained one")
    log("  finetune: slot 1 exported (HF PEFT) and loaded into a fresh engine's slot 0 bitwise")
    for k in ("qmm_int8", "decode_attention", "flash_prefill"):
        require(out["launches"][k] > 0, f"{k} was never launched in the co-scheduled run")
    out["card"] = card
    _log_served("finetune base (no session)", out["base"], card)
    _log_served("finetune co-scheduled (session on slot 1)", out, card)
    log(f"  finetune: co-scheduled tokens equal the run without a session; decode tok/s with "
        f"/ without the session {out['decode_tok_s']:.1f} / {out['base']['decode_tok_s']:.1f}; "
        f"{out['slot1_requests_changed']} of 8 slot-1 requests changed tokens after training "
        f"[{card}]")
    del engine, other, rm, fresh
    torch.cuda.empty_cache()
    return out


def _param_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _param_leaves(v, f"{prefix}{k}/")
        elif v is not None:
            yield f"{prefix}{k}", v


def train_phase(card: str) -> dict:
    """The Trainer at LLaMA-2-7B width, TRAIN_LAYERS layers (f32 params,
    gradients and Adam's m and v take 16 B a parameter: 32 layers would not
    fit the card), seed 0: a B=1, T=64 first step on the card against the
    same step on the CPU (loss rtol 1e-4, gradients 1e-4 of each leaf's
    magnitude, updated parameters atol 1e-5 where the gradient's sign is
    decided), TRAIN_STEPS Adam steps on one fixed TRAIN_BATCH x TRAIN_LEN
    batch (the loss must fall), and a save_checkpoint / load_checkpoint
    resume that gives the same next loss."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.specs import ModelSpec
    from flexflow_tpu_torch.training import AdamOptimizer, Trainer
    from flexflow_tpu_torch.training.losses import sparse_categorical_crossentropy
    from flexflow_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
            "train: TF32 must stay off for the f32 comparison")
    dev, host = torch.device("cuda"), torch.device("cpu")
    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": TRAIN_LAYERS})
    t0 = time.perf_counter()
    params = params_lib.init_params(spec, 0, torch.float32, host)
    n_params = sum(p.numel() for _, p in _param_leaves(params))
    out = dict(params=n_params, init_s=time.perf_counter() - t0)
    rng = np.random.default_rng(7)
    ids = rng.integers(3, spec.vocab_size, (1, 65)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]

    def grads_of(tr):
        """The step's gradients (the Trainer's forward and loss, no update)."""
        t = torch.as_tensor(x, device=tr.device)
        pos = torch.arange(t.shape[1], dtype=torch.int32, device=tr.device)[None]
        logits, _ = decoder.forward(spec, tr.params, t, pos)
        sparse_categorical_crossentropy(logits, torch.as_tensor(y, device=tr.device)).backward()
        g = {}
        for name, p in _param_leaves(tr.params):
            g[name] = p.grad.detach().to(host, copy=True)
            p.grad = None
        return g

    ref = {}
    for name, d in (("cpu", host), ("gpu", dev)):
        t1 = time.perf_counter()
        tr = Trainer(spec, params, AdamOptimizer(lr=TRAIN_LR), device=d)
        grads = grads_of(tr)
        loss = tr.train_step(x, y)
        new = {k: p.detach().to(host, copy=True) for k, p in _param_leaves(tr.params)}
        ref[name] = (loss, grads, new)
        log(f"  first step (1 x 64 tokens) on the {name}: loss {loss:.6f} in "
            f"{time.perf_counter() - t1:.1f} s with the gradient probe")
        del tr
    (lc, gc, pc), (lg, gg, pg) = ref["cpu"], ref["gpu"]
    require(abs(lg - lc) <= 1e-4 * abs(lc), f"train: first loss {lg} on the card vs {lc}")
    worst_g, undecided, off = 0.0, 0, 0
    for k in gc:
        err = (gg[k] - gc[k]).abs()
        scale = gc[k].abs().max().item()
        worst_g = max(worst_g, err.max().item() / max(scale, 1e-30))
        # Adam's first update is lr * g / (|g| + eps): about lr * sign(g). A
        # gradient within the two sides' difference may take either sign.
        decided = gc[k].abs() > 2 * err.max()
        dp = (pg[k] - pc[k]).abs()
        off += int((dp[decided] > 1e-5).sum())
        undecided += int((~decided & (dp > 1e-5)).sum())
        require(bool((dp[~decided] <= 2 * TRAIN_LR + 1e-5).all()),
                f"train: {k} moved apart by more than 2 lr")
    require(worst_g <= 1e-4, f"train: gradients differ by {worst_g} of their magnitude")
    require(off == 0, f"train: {off} updated parameters with a decided gradient sign differ by "
                      "more than 1e-5")
    out.update(first_loss_gpu=lg, first_loss_cpu=lc, grad_rel_err=worst_g,
               sign_ties_apart=undecided)
    log(f"  first step: loss {lg:.6f} vs CPU {lc:.6f}; gradients within {worst_g:.3g} of each "
        f"leaf's magnitude; updated parameters within 1e-5 except {undecided} of {n_params} "
        f"whose gradient sign the two sides' difference leaves open (Adam moves them by "
        f"+-lr)")
    del ref, gc, gg, pc, pg

    batch = rng.integers(3, spec.vocab_size, (TRAIN_BATCH, TRAIN_LEN + 1)).astype(np.int32)
    bx, by = batch[:, :-1], batch[:, 1:]
    tr = Trainer(spec, params, AdamOptimizer(lr=TRAIN_LR), device=dev)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        losses.append(tr.train_step(bx, by))  # returns a float: the step has finished
        step_s.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
    step_ms = 1e3 * float(np.mean(step_s[1:]))
    out.update(losses=losses, step_ms=step_ms, first_step_ms=1e3 * step_s[0],
               tokens_per_s=TRAIN_BATCH * TRAIN_LEN / (step_ms / 1e3), peak_mem_gib=peak)
    log(f"  {TRAIN_STEPS} Adam steps on {TRAIN_BATCH} x {TRAIN_LEN} tokens: losses "
        f"{[round(v, 4) for v in losses]}; step {step_ms:.1f} ms (first {1e3 * step_s[0]:.1f}), "
        f"{out['tokens_per_s']:.0f} tokens/s, peak memory {peak:.2f} GiB, {n_params} parameters "
        f"[{card}]")

    t1 = time.perf_counter()
    buf = io.BytesIO()
    save_checkpoint(buf, {"params": tr.params, "opt_state": tr.opt_state})
    buf.seek(0)
    state = load_checkpoint(buf, device=dev)
    del buf
    resumed = Trainer(spec, state["params"], AdamOptimizer(lr=TRAIN_LR), device=dev)
    resumed.opt_state = state["opt_state"]
    del state
    out["checkpoint_s"] = time.perf_counter() - t1
    want, got = tr.train_step(bx, by), resumed.train_step(bx, by)
    require(abs(got - want) <= 1e-6 * abs(want),
            f"train: the resumed step's loss {got} vs {want}")
    out.update(next_loss=want, resumed_loss=got)
    log(f"  checkpoint save + load + resume {out['checkpoint_s']:.1f} s: next loss {got:.6f} "
        f"equals the uninterrupted run's {want:.6f}")
    del tr, resumed
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(DEFAULT_PHASES),
                    help="comma-separated phases to run (default: all but profile)")
    ap.add_argument("--profile", action="store_true",
                    help="add the profile phase (traces the serve and spec phases run)")
    ap.add_argument("--reps", type=int, default=20, help="timed launches per kernel")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout holding an earlier quant_matmul.cu, flash_prefill.cu and/or "
                         "decode_attention.cu: each built beside this one and timed beside its "
                         "rows; INT8 qmm held bitwise equal to it, the attention kernels to the "
                         "same limits as this tree's")
    args = ap.parse_args(argv)
    phases = [p for p in args.only.split(",") if p] + (["profile"] if args.profile else [])
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from flexflow_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flexflow_tpu_torch.benchmarks import tune_quant_kernel as tq

    card = tq.card(torch.device("cuda"))
    log(card)  # nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"[card] host memory: MemTotal {_meminfo_gib('/proc/meminfo', 'MemTotal'):.2f} GiB, "
        f"MemAvailable {_mem_available_gib():.2f} GiB with a CUDA context")

    t_start = t0 = time.perf_counter()
    _build.lib()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {'cached' if _build.build_seconds is None else f'{_build.build_seconds:.1f} s'})")
    entry = ""  # the kernel (mangled, past its file's namespace) each ptxas line is about
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", line.split("'")[1])[:80]
        elif "registers" in line or "spill" in line:
            log(f"[build]   {entry}: {line.strip()}")
        elif line.startswith("=="):
            log(f"[build]   {line.strip()}")

    parent = {}
    if args.parent:
        t0 = time.perf_counter()
        parent = build_parent(args.parent)
        log(f"[build] earlier {', '.join(f'{n}.cu' for n in parent)} from {args.parent} built "
            f"and loaded in {time.perf_counter() - t0:.1f} s")

    records: list = []
    summary: dict = {}
    held: dict = {}  # the serve phase's model, kept for the openai phase
    phase_s = {"build": time.perf_counter() - t_start}
    t0 = time.perf_counter()

    def lap(name):  # seconds since the last lap, under the phase's name
        nonlocal t0
        phase_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    if "kernels" in phases:
        for bits in (8, 4):
            log(f"[kernels] qmm_int{bits}")
            qmm_phase(bits, args.reps, records, parent.get("quant_matmul"))
        log("[kernels] decode_attention")
        decode_attention_phase(args.reps, records, parent.get("decode_attention"))
        log("[kernels] flash_prefill")
        flash_prefill_phase(args.reps, records, parent.get("flash_prefill"))
        lap("kernels")
    if "variants" in phases:
        log("[variants] quant-kernel tuning path: six dequant-matmul variants x "
            "column widths, qmm_int8 / qmm_int4, B=8 4096x11008 g=128")
        summary["variants"] = variants_phase(args.reps, records)
        lap("variants")
    if "crosscheck" in phases:
        for bits in (8, 4):
            log(f"[crosscheck] 2-layer LLaMA-2-7B-width INT{bits}, GPU kernels vs CPU plain")
            summary[f"crosscheck_int{bits}"] = crosscheck_phase(bits)
        lap("crosscheck")
    if "serve" in phases:
        log("[serve] LLaMA-2-7B INT8, 8 requests, decode_horizon=16, pipelined")
        summary["serve"] = serve_phase(card, "profile" in phases,
                                       held if "openai" in phases else None)
        lap("serve")
    if "openai" in phases:
        log("[openai] the served model behind LLM.start_server() and the OpenAI endpoint on "
            "loopback: 1 sampled request, 8 client threads, 1 stream, 2 refusals")
        summary["openai"] = openai_phase(card, held)
        # the serve phase's engine (reference cycles through its manager's
        # threads): freed before later phases measure their peak memory
        held.clear()
        gc.collect()
        torch.cuda.empty_cache()
        lap("openai")
    if "spec" in phases:
        log("[spec] LLaMA-2-7B INT4 verifier + 160M-class draft, tree width 3 depth 4, "
            "8 requests, fused and pipelined; then a second draft (width 1 depth 6) beside it, "
            "rotated and merged")
        summary["spec"] = spec_phase(card, "profile" in phases)
        lap("spec")
    if "mixtral" in phases:
        log("[mixtral] Mixtral-8x7B INT8 (32 layers, 8 experts top-2), 8 requests, "
            "decode_horizon=16, pipelined; the 2-layer cross-check first; then Mixtral as the "
            "verifier of a 160M-class draft, width 3 depth 4")
        summary["mixtral"] = mixtral_phase(card, "profile" in phases)
        lap("mixtral")
    if "offload" in phases:
        log("[offload] CPU offload: (a) LLaMA-2-7B INT8 resident against offload, 8 requests x 64 "
            "tokens; (b) Mixtral-8x7B bf16, 4 layers, resident against offload, logits bitwise; "
            f"(c) Mixtral-8x7B bf16, {OFFLOAD_LAYERS} layers from pinned host memory, 8 requests "
            f"x {OFFLOAD_NEW_TOKENS} tokens")
        summary["offload"] = offload_phase(card)
        lap("offload")
    if "lora" in phases:
        log("[lora] LLaMA-2-7B INT8 with 4 LoRA adapters (rank 16, all seven projections), "
            "8 requests routed " + str(LORA_IDS) + ", decode_horizon=16, pipelined; the "
            "2-layer cross-check first")
        summary["lora"] = lora_phase(card, "profile" in phases)
        lap("lora")
    if "finetune" in phases:
        log("[finetune] LLaMA-2-7B INT8 (32 layers) with 2 LoRA slots (rank 16, wq and wv): "
            "gradients through the kernels against the plain path, then SGD finetuning of slot 1 "
            f"({FT_STEPS} steps of {FT_LEN} tokens) co-scheduled with 8 requests routed "
            f"{FT_IDS}")
        summary["finetune"] = finetune_phase(card)
        lap("finetune")
    if "train" in phases:
        log(f"[train] the Trainer at LLaMA-2-7B width, {TRAIN_LAYERS} layers, f32, Adam: "
            f"a first step against the CPU, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_LEN} "
            "tokens, a checkpoint resume")
        summary["train"] = train_phase(card)
        lap("train")

    # each path's launches, counted from 0 over its run: the served runs for
    # the serving kernels (two drafts rotated and merged, and Mixtral as a
    # verifier, among them), the tuning run for the variants
    served = [summary.get(p, {}) for p in ("serve", "openai", "spec", "mixtral", "lora",
                                           "finetune")]
    served += [summary.get("spec", {}).get(m, {}) for m in ("rotation", "merged")]
    served.append(summary.get("mixtral", {}).get("spec", {}))
    offload = summary.get("offload", {})
    served += [offload.get("llama", {}).get(r, {}) for r in ("resident", "offload")]
    served.append(offload.get("mixtral", {}))
    launches = {k: sum(run.get("launches", {}).get(k, 0)
                       for run in ([summary.get("variants", {})] if k in VARIANTS else served))
                for k in SOURCES}
    kernels = [
        dict(name=r["name"], route="cuda", source=SOURCES[r["kernel"]],
             replaces=REPLACES[r["kernel"]], launches=launches[r["kernel"]],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"])
        for r in records
    ]
    summary["phase_seconds"] = phase_s
    log(f"[done] phases {','.join(phases)} in {time.perf_counter() - t_start:.1f} s, the build "
        f"included; seconds per phase {json.dumps({k: round(v, 1) for k, v in phase_s.items()})} "
        f"[{card}]")
    log(json.dumps({"summary": summary, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
