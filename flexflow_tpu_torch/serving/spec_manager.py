"""SpecRequestManager — continuous batching for tree-speculative serving
(port of ``flexflow_tpu/serving/spec_manager.py``, one draft model).

Each iteration drafts a token tree per slot, verifies it with the verifier,
accepts the longest verified path and commits its K/V. Greedy verification
is lossless: outputs equal incremental greedy decoding. Requests that sample
(temperature > 0) go through stochastic verification
(``spec_sampling.tree_sample_walk``).

Keys: one ``torch.Generator`` draws a 63-bit key per dispatch (see
``ops/sampling``). The background serving thread is the incremental
manager's (``request_manager.BackgroundServing``), and ``--profiling``
times the phases as there. The stepwise path (``fused=False``) refuses
sampled requests, where the JAX package walks them greedily.
``MultiSSMSpecManager`` (several drafts) is not in the port yet.
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from flexflow_tpu_torch.config import config as _ffconfig
from flexflow_tpu_torch.ops.sampling import SamplingConfig
from flexflow_tpu_torch.serving.request_manager import (
    COMPLETED,
    RUNNING,
    BackgroundServing,
    GenerationConfig,
    Request,
)
from flexflow_tpu_torch.serving.speculative import SpecEngine
from flexflow_tpu_torch.utils.profiling import StepTimer


# the JAX package's SpecEngine serves no adapter and drops adapter_id silently
NO_ADAPTERS = ("LoRA adapters are not served under speculative decoding: the JAX package's "
               "SpecEngine ignores adapter_id, and the port refuses it instead (ROADMAP.md, "
               "the port's deliberate differences)")


class SpecRequestManager(BackgroundServing):
    """Continuous-batching scheduler over a SpecEngine."""

    def __init__(
        self,
        engine: SpecEngine,
        *,
        eos_token_ids: Sequence[int] = (),
        fused: bool = False,
        spec_horizon: int = 1,
        pipelined: bool = False,
        pipeline_depth: Optional[int] = None,  # None -> FFConfig.pipeline_depth
        seed: int = 0,
        log_fn=None,
    ):
        """``fused=True`` runs each iteration (draft tree, verify, accept,
        commit) on the device with no host round trip inside it;
        ``spec_horizon`` > 1 chains that many iterations per dispatch (lens
        and roots feed back on the device; EOS and retirement lag one
        horizon). ``pipelined`` (needs ``fused``) dispatches horizon k+1
        before fetching horizon k, keeping up to ``pipeline_depth`` horizons
        in flight."""
        self.engine = engine
        self.fused = bool(fused)
        self.spec_horizon = max(int(spec_horizon), 1)
        self.pipelined = bool(pipelined) and self.fused
        if pipeline_depth is None:
            pipeline_depth = _ffconfig.pipeline_depth
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self._inflight_q = []  # FIFO of (snapshot, produced, n_acc, h)
        self._dev_lens = None  # device [B] feedback (pipelined mode)
        self._dev_roots = None
        self.eos_token_ids = tuple(eos_token_ids) or engine.llm_spec.eos_ids()
        self._guid = itertools.count(2000000)
        self._pending: "queue.Queue[Request]" = queue.Queue()
        self._requests: Dict[int, Request] = {}
        self._init_server()
        self.timer = StepTimer() if _ffconfig.profiling else None

        b = engine.max_requests
        self._slots: List[Optional[Request]] = [None] * b
        self._cache_lens = np.zeros(b, np.int32)
        self._root_tokens = np.zeros(b, np.int32)
        # per-slot sampling parameters; any temperature > 0 sends the step
        # through stochastic verification
        self._temperature = np.zeros(b, np.float32)
        self._top_p = np.ones(b, np.float32)
        self._top_k = np.zeros(b, np.int32)
        self._gen = torch.Generator().manual_seed(seed)
        self._steps = 0
        self._verified_tokens_total = 0  # accepted tokens over (request, iteration)
        self._verified_events = 0
        # iterations dispatched but not yet fetched, per slot
        self._inflight_iters = np.zeros(b, np.int64)
        # tail horizons: "down" dispatches the largest power of two below the
        # remaining-iteration estimate and covers the rest with smaller
        # dispatches; "up" the smallest power of two above it
        self.horizon_round = "down"
        self._num_processed = 0
        self._tree_margin = engine.tree  # sequence room reserved per iteration
        self._override_mask = np.zeros(b, bool)  # slots admitted since the last dispatch
        self._log = log_fn or (lambda *a: None)

    # ------------------------------------------------------------------

    def get_request(self, guid: int) -> Request:
        return self._requests[guid]

    def _margin(self) -> int:
        return self.spec_horizon * (self._tree_margin + 1)

    def register_request(self, prompt_tokens: Sequence[int],
                         config: Optional[GenerationConfig] = None) -> int:
        config = config or GenerationConfig()
        if len(prompt_tokens) + self._margin() >= self.engine.max_seq_len:
            raise ValueError(
                f"prompt length {len(prompt_tokens)} + speculation margin "
                f"{self._margin()} >= max_seq_len {self.engine.max_seq_len}")
        if config.adapter_id >= 0:
            raise NotImplementedError(NO_ADAPTERS)
        req = Request(guid=next(self._guid), prompt_tokens=list(prompt_tokens), config=config)
        return self._enqueue(req)

    def _phase(self, name: str):
        return contextlib.nullcontext() if self.timer is None else self.timer.phase(name)

    def _finished(self, req: Request, last_token: int) -> bool:
        if last_token in self.eos_token_ids or last_token in tuple(req.config.stop_token_ids):
            return True
        if len(req.output_tokens) >= req.config.max_new_tokens:
            return True
        # leave room for a full horizon of speculation trees
        total = len(req.prompt_tokens) + len(req.output_tokens)
        return total + self._margin() >= self.engine.max_seq_len

    def _next_key(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._gen))

    def _scfg(self) -> SamplingConfig:
        return SamplingConfig(temperature=self._temperature, top_p=self._top_p,
                              top_k=self._top_k)

    def _retire(self, slot: int) -> None:
        req = self._slots[slot]
        req.state = COMPLETED
        req.profile.finish_time = time.monotonic()
        self._slots[slot] = None
        self._cache_lens[slot] = 0
        self._temperature[slot] = 0.0
        self._top_p[slot] = 1.0
        self._top_k[slot] = 0
        self._inflight_iters[slot] = 0
        self._num_processed += 1
        self._log(f"[Profile] guid({req.guid}) llm_decoding_steps("
                  f"{req.profile.llm_decoding_steps}) latency({req.profile.latency * 1e3:.3f}) "
                  f"ttft({req.profile.ttft * 1e3:.3f})")
        req.done.set()

    def _admit(self) -> None:
        """Batched admission: every pending request that finds a free slot
        is prefilled into both caches in one call."""
        admits = []
        for slot in range(self.engine.max_requests):
            if self._slots[slot] is not None:
                continue
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            req.state = RUNNING
            req.slot = slot
            req.profile.start_time = time.monotonic()
            self._temperature[slot] = req.config.temperature
            self._top_p[slot] = req.config.top_p
            self._top_k[slot] = req.config.top_k
            self._slots[slot] = req
            self._cache_lens[slot] = len(req.prompt_tokens)
            admits.append((slot, req))
        if not admits:
            return
        sampling = any(r.config.temperature > 0.0 for _, r in admits)
        scfg = None
        if sampling:
            scfg = SamplingConfig(
                temperature=np.array([r.config.temperature for _, r in admits], np.float32),
                top_p=np.array([r.config.top_p for _, r in admits], np.float32),
                top_k=np.array([r.config.top_k for _, r in admits], np.int32))
        firsts = self.engine.prefill_both_batch(
            [np.asarray(r.prompt_tokens, np.int32) for _, r in admits],
            [s for s, _ in admits], key=self._next_key() if sampling else None, scfg=scfg)
        now = time.monotonic()
        for (slot, req), first in zip(admits, firsts):
            req.profile.first_token_time = now
            req.profile.llm_decoding_steps = 1
            req.output_tokens.append(first)
            self._root_tokens[slot] = first
            self._override_mask[slot] = True
            if self._finished(req, first):
                self._retire(slot)

    # ------------------------------------------------------------------

    def _clamped_horizon(self, active, *, projected: bool = False) -> int:
        """Drain-aware horizon: never chain more iterations than the largest
        remaining token budget of the active slots needs (each iteration
        yields at least one token per slot).

        ``projected`` (pipelined mode) also credits in-flight iterations
        with the measured mean acceptance, and caps the dispatch so that
        even worst-case acceptance (depth + 1 tokens per in-flight
        iteration) cannot write past the cache. Returns 0 when every active
        budget is already covered (the caller drains instead). Lossless
        either way: only wasted tail iterations are skipped."""
        if not projected:
            rem = max(self._slots[s].config.max_new_tokens - len(self._slots[s].output_tokens)
                      for s in active)
            cap = self.spec_horizon
        else:
            acc = max(self.mean_verified_tokens_per_step, 1.0)
            worst = self.engine.depth + 1
            rem = 0
            cap = self.spec_horizon
            for s in active:
                req = self._slots[s]
                proj = len(req.output_tokens) + self._inflight_iters[s] * acc
                rem = max(rem, int(np.ceil((req.config.max_new_tokens - proj) / acc)))
                worst_lens = (len(req.prompt_tokens) + len(req.output_tokens)
                              + self._inflight_iters[s] * worst)
                seq_room = self.engine.max_seq_len - worst_lens - (self._tree_margin + 1)
                cap = min(cap, max(int(seq_room) // worst, 0))
            rem = min(rem, cap)
            if rem <= 0:
                return 0
        # powers of two, so few distinct horizons are dispatched
        h = 1
        while h < rem and h < self.spec_horizon:
            h *= 2
        if self.horizon_round == "down" and h > rem:
            h = max(h // 2, 1)
        if projected:
            # the seq-room cap is a cache-safety bound: it holds under every
            # rounding mode
            h = min(h, cap)
        return min(h, self.spec_horizon)

    def _step_fused(self, active) -> bool:
        lens_before = self._cache_lens.copy()
        h = self._clamped_horizon(active)
        window = self.engine.attn_window_bucket(int(max(lens_before[s] for s in active)))
        if any(self._temperature[s] > 0.0 for s in active):
            produced, n_acc = self.engine.fused_sample_step_n(
                lens_before, self._root_tokens, self._next_key(), self._scfg(), h,
                window=window)
        else:
            produced, n_acc = self.engine.fused_step_n(
                lens_before, self._root_tokens, h, window=window)
        self._steps += h
        self._process_produced([(s, self._slots[s]) for s in active], produced, n_acc, h)
        return True

    def _process_produced(self, snapshot, produced, n_acc, h: int) -> None:
        """Apply one fetched horizon's (produced, n_acc) to the slots that
        were active at dispatch time; extend outputs, retire finished."""
        for slot, req in snapshot:
            if self._slots[slot] is not req:
                continue  # retired (and possibly readmitted) since dispatch
            for it in range(h):
                n = int(n_acc[it, slot])
                budget = req.config.max_new_tokens - len(req.output_tokens)
                kept = []
                for tok in produced[it, slot, :n][: max(budget, 0)]:
                    kept.append(int(tok))
                    if kept[-1] in self.eos_token_ids or kept[-1] in tuple(
                            req.config.stop_token_ids):
                        break
                req.output_tokens.extend(kept)
                req.profile.llm_decoding_steps += 1
                self._verified_tokens_total += n
                self._verified_events += 1
                self._cache_lens[slot] += n
                self._root_tokens[slot] = int(produced[it, slot, n - 1])
                if self._finished(req, req.output_tokens[-1]):
                    self._retire(slot)
                    break

    def _step_fused_pipelined(self, active) -> bool:
        """Dispatch horizon k+1 before fetching horizon k: lens and roots
        stay on the device between dispatches, and admissions merge in
        through a [B] override. EOS and retirement lag one more horizon."""
        h = self._clamped_horizon(active, projected=True)
        if h == 0:
            # budgets covered by in-flight work: drain instead of dispatch
            if self._inflight_q:
                self._drain_inflight(self._inflight_q.pop(0))
            return True
        if self._dev_lens is None:
            self._dev_lens = self.engine._h(self._cache_lens)
            self._dev_roots = self.engine._h(self._root_tokens)
        elif self._override_mask.any():
            self._dev_lens, self._dev_roots = self.engine.apply_slot_overrides(
                self._dev_lens, self._dev_roots, self._override_mask, self._cache_lens,
                self._root_tokens)
        self._override_mask = np.zeros(self.engine.max_requests, bool)
        # drained lens + in-flight iterations x (depth + 1) bounds every
        # slot's committed length when this horizon runs
        window = self.engine.attn_window_bucket(int(max(
            self._cache_lens[s] + self._inflight_iters[s] * (self.engine.depth + 1)
            for s in active)))
        if any(self._temperature[s] > 0.0 for s in active):
            produced, n_acc, self._dev_lens, self._dev_roots = (
                self.engine.fused_sample_step_n_async(
                    self._dev_lens, self._dev_roots, self._next_key(), self._scfg(), h,
                    window=window))
        else:
            produced, n_acc, self._dev_lens, self._dev_roots = self.engine.fused_step_n_async(
                self._dev_lens, self._dev_roots, h, window=window)
        self._steps += h
        for s in active:
            self._inflight_iters[s] += h
        self._inflight_q.append(([(s, self._slots[s]) for s in active], produced, n_acc, h))
        # keep up to pipeline_depth horizons queued; drain the oldest beyond
        while len(self._inflight_q) > max(self.pipeline_depth - 1, 1):
            self._drain_inflight(self._inflight_q.pop(0))
        return True

    def _drain_inflight(self, inflight) -> None:
        snapshot, produced, n_acc, h = inflight
        produced = self.engine.fetch(produced)
        n_acc = self.engine.fetch(n_acc)
        for slot, _ in snapshot:
            self._inflight_iters[slot] = max(0, self._inflight_iters[slot] - h)
        self._process_produced(snapshot, produced, n_acc, h)

    def step(self) -> bool:
        """One scheduling iteration; True while any request is in flight."""
        with self._phase("admit"):
            self._admit()
        active = [s for s in range(self.engine.max_requests) if self._slots[s]]
        if not active:
            if self._inflight_q:
                with self._phase("spec_drain"):
                    self._drain_inflight(self._inflight_q.pop(0))
                return True
            return False
        if self.fused:
            with self._phase("spec_fused"):
                if self.pipelined:
                    return self._step_fused_pipelined(active)
                return self._step_fused(active)
        if any(self._temperature[s] > 0.0 for s in active):
            raise NotImplementedError(
                "sampling requests need fused=True (stochastic verification runs in the "
                "fused iteration)")
        lens_before = self._cache_lens.copy()
        with self._phase("draft"):
            tree_tokens, tree_parents, tree_depths = self.engine.draft_tree(
                lens_before, self._root_tokens)
        with self._phase("verify"):
            argmax = self.engine.verify(lens_before, tree_tokens, tree_parents, tree_depths)
        from_slots = self._greedy_walk_accept(active, lens_before, tree_tokens, tree_parents,
                                              argmax)
        self.engine.commit(lens_before, from_slots)
        return True

    def _greedy_walk_accept(self, active, lens_before, tree_tokens, tree_parents,
                            argmax) -> np.ndarray:
        """Walk each request's verified tree along the verifier's argmaxes,
        extend outputs and advance cache lens; returns the K/V commit's
        from_slots."""
        t = self.engine.tree
        self._steps += 1
        from_slots = np.tile(np.arange(t, dtype=np.int32), (len(lens_before), 1))
        for slot in active:
            req = self._slots[slot]
            children: Dict[int, List[int]] = {}
            for c in range(1, t):
                children.setdefault(int(tree_parents[slot, c]), []).append(c)
            cur, path, produced = 0, [0], []
            while True:
                expected = int(argmax[slot, cur])
                produced.append(expected)
                nxt = next((c for c in children.get(cur, ())
                            if int(tree_tokens[slot, c]) == expected), None)
                if nxt is None:
                    break
                cur = nxt
                path.append(cur)
            budget = req.config.max_new_tokens - len(req.output_tokens)
            kept = []
            for tok in produced[: max(budget, 0)]:
                kept.append(tok)
                if tok in self.eos_token_ids or tok in tuple(req.config.stop_token_ids):
                    break
            req.output_tokens.extend(kept)
            req.profile.llm_decoding_steps += 1
            self._verified_tokens_total += len(path)
            self._verified_events += 1
            from_slots[slot, : len(path)] = path
            self._cache_lens[slot] = lens_before[slot] + len(path)
            self._root_tokens[slot] = produced[-1]
            if self._finished(req, req.output_tokens[-1]):
                self._retire(slot)
        return from_slots

    def _drop_inflight(self) -> None:
        for slot in range(self.engine.max_requests):
            if self._slots[slot] is not None:
                self._slots[slot] = None
                self._cache_lens[slot] = self._inflight_iters[slot] = 0
                self._temperature[slot], self._top_p[slot], self._top_k[slot] = 0.0, 1.0, 0
        self._inflight_q, self._dev_lens, self._dev_roots = [], None, None
        self._override_mask[:] = False

    def run_until_idle(self) -> None:
        while self.step() or not self._pending.empty():
            pass
        if self.timer is not None:
            for line in self.timer.report():
                print(line)

    def generate(self, prompts, config: Optional[GenerationConfig] = None) -> List[Request]:
        """Synchronous batch generate (token-id interface); see
        :meth:`BackgroundServing.finish`."""
        if prompts and isinstance(prompts[0], int):
            prompts = [prompts]
        return self.finish([self.register_request(p, config) for p in prompts])

    # ------------------------------------------------------------------

    @property
    def mean_verified_tokens_per_step(self) -> float:
        """Mean accepted tokens per request per speculative iteration."""
        return self._verified_tokens_total / max(self._verified_events, 1)

    @property
    def total_decoding_steps(self) -> int:
        return self._steps

    @property
    def num_processed_requests(self) -> int:
        return self._num_processed
