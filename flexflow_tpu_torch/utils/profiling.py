"""Profiling hooks: per-phase wall times, a ``torch.profiler`` trace and
per-op forward timing (port of ``flexflow_tpu/utils/profiling.py``).

``--profiling`` (``FFConfig.profiling``) makes the request managers time
their phases with a :class:`StepTimer` and print its report when a workload
drains; the incremental manager also prints :func:`per_op_profile` once.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List


class StepTimer:
    """Accumulates per-phase wall times (prefill/decode/spec-step/...)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> List[str]:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(
                f"[Profile] {name}: total {tot * 1e3:.2f} ms, "
                f"count {n}, mean {tot / n * 1e3:.3f} ms"
            )
        return lines


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (the CPU, and the card when
    there is one), written to ``log_dir/trace.json`` (chrome://tracing,
    Perfetto). Failures are reported, not raised."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # pragma: no cover
        prof = None
        print(f"[Profile] trace capture unavailable: {e}")
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
            except Exception as e:  # pragma: no cover
                print(f"[Profile] trace export failed: {e}")


def _time_ms(fn, args, reps: int, device) -> float:
    """Mean ms of ``fn(*args)`` after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    import torch

    fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps * 1e3


def per_op_profile(spec, params, *, batch: int = 1, seq: int = 32,
                   cache_len: int = 128, reps: int = 10):
    """Per-op forward timing of one decoder layer (layer 0) and the
    embedding and LM head, each op called on its own, in the reference's
    per-kernel report style; the row names are the JAX package's. Returns
    the report lines."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.ops import attention as attn_lib

    device = params["embed_tokens"].device
    layer0 = decoder._layer_params(params["layers"], 0)
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(1, spec.vocab_size, size=(batch, seq)),
                           dtype=torch.int32, device=device)
    positions = torch.arange(seq, dtype=torch.int32, device=device)[None].expand(batch, seq)
    with torch.no_grad():
        h = decoder._embed(spec, params, toks, positions)
    dt_c = h.dtype
    q = torch.as_tensor(rng.randn(batch, seq, spec.num_heads, spec.head_dim),
                        dtype=dt_c, device=device)
    k = torch.as_tensor(rng.randn(batch, seq, spec.num_kv_heads, spec.head_dim),
                        dtype=dt_c, device=device)
    ck = torch.as_tensor(rng.randn(batch, spec.num_kv_heads, cache_len, spec.head_dim),
                         dtype=dt_c, device=device)
    lens = torch.full((batch,), cache_len - seq, dtype=torch.int32, device=device)

    ops = {
        "RMSNorm" if spec.norm == "rmsnorm" else "LayerNorm": (
            lambda p, x: decoder._norm(spec, x, p["ln1_scale"], p.get("ln1_bias")),
            (layer0, h)),
        "Linear (qkv)": (lambda p, x: decoder._qkv(spec, p, x), (layer0, h)),
        "IncMultiHeadSelfAttention": (
            lambda qq, kk, vv, c1, c2, ll: attn_lib.split_cached_attention(
                qq, c1, c2, kk, vv, ll),
            (q, k, k, ck, ck, lens)),
        "Linear (o_proj)": (lambda p, a: decoder._attn_out(spec, p, a), (layer0, q)),
        "MLP (gate/up/down)" if spec.act == "silu_gate" else "MLP": (
            lambda p, x: decoder._mlp(spec, p, x), (layer0, h)),
        "Embedding": (lambda pp, t: decoder._embed(spec, pp, t, positions), (params, toks)),
        "LMHead (linear)": (lambda pp, x: decoder._unembed(spec, pp, x), (params, h)),
    }
    lines = []
    for name, (fn, args) in ops.items():
        try:
            with torch.no_grad():
                ms = _time_ms(fn, args, reps, device)
        except Exception as e:  # op not applicable to this spec
            lines.append(f"[Profile] {name}: skipped ({type(e).__name__})")
            continue
        lines.append(
            f"[Profile] {name} forward time = {ms:.4f}ms "
            f"(B={batch} T={seq} S={cache_len}, per layer)"
        )
    return lines
