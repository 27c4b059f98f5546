"""RequestManager — continuous-batching scheduler (port of
``flexflow_tpu/serving/request_manager.py``).

Slot-based continuous batching over an :class:`InferenceEngine`: requests
are admitted into free slots (batched prefill), decoded in horizons of up to
``decode_horizon`` steps, and retired on EOS, stop tokens, their token budget
or a full cache. With ``pipelined=True`` horizon k+1 is dispatched before
horizon k's tokens are fetched; the fetch (``.cpu()``) runs on a worker
thread. Outputs are identical either way.

``jax.random`` keys become one ``torch.Generator`` that draws a 63-bit step
key per dispatch (see ``ops/sampling``). The horizon bookkeeping is the
Python loop of the JAX package (its native scheduler belongs to the JAX
package). Each slot carries its request's LoRA adapter id (-1: none) into
every prefill and horizon, as in JAX. Co-scheduled finetuning, the
per-phase profiler and the background serving thread are not in the port
yet.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from flexflow_tpu_torch.ops.sampling import SamplingConfig
from flexflow_tpu_torch.serving.engine import InferenceEngine


@dataclasses.dataclass
class GenerationConfig:
    """Per-request sampling settings."""

    max_new_tokens: int = 128
    temperature: float = 0.0  # <= 0 -> greedy
    top_p: float = 1.0
    top_k: int = 0
    stop_token_ids: Sequence[int] = ()
    adapter_id: int = -1  # LoRA adapter slot of the engine (-1 = base model)


@dataclasses.dataclass
class ProfileInfo:
    registration_time: float = 0.0
    start_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    llm_decoding_steps: int = 0

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.registration_time

    @property
    def latency(self) -> float:
        return self.finish_time - self.registration_time


PENDING, RUNNING, COMPLETED = ("PENDING", "RUNNING", "COMPLETED")


@dataclasses.dataclass
class Request:
    guid: int
    prompt_tokens: List[int]
    config: GenerationConfig
    state: str = PENDING
    slot: int = -1
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    profile: ProfileInfo = dataclasses.field(default_factory=ProfileInfo)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)

    @property
    def tokens(self) -> List[int]:
        return self.prompt_tokens + self.output_tokens


class RequestManager:
    """Continuous-batching scheduler over an InferenceEngine."""

    def __init__(
        self,
        engine: InferenceEngine,
        *,
        eos_token_ids: Sequence[int] = (),
        seed: int = 0,
        decode_horizon: int = 1,
        pipelined: bool = False,
        pipeline_depth: int = 2,
        log_fn=None,
    ):
        self.engine = engine
        self.decode_horizon = max(int(decode_horizon), 1)
        self.pipelined = bool(pipelined)
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self._inflight_q = []  # [(kind, fetch future, entries), ...]
        self._fetcher = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._feedback = None  # device [B] tokens from the last dispatch
        self._feedback_overrides = []  # [(slot, token)] set at admit time
        self.eos_token_ids = tuple(eos_token_ids) or engine.spec.eos_ids()
        self._guid = itertools.count(1000000)
        self._pending: "queue.Queue[Request]" = queue.Queue()
        self._requests: Dict[int, Request] = {}

        b = engine.max_requests
        self._slots: List[Optional[Request]] = [None] * b
        self._cache_lens = np.zeros(b, np.int32)
        self._tokens = np.zeros(b, np.int32)
        self._temperature = np.zeros(b, np.float32)
        self._top_p = np.ones(b, np.float32)
        self._top_k = np.zeros(b, np.int32)
        self._adapter = np.full(b, -1, np.int64)  # each slot's LoRA adapter
        self._gen = torch.Generator().manual_seed(seed)
        self._steps = 0
        self._num_processed = 0
        self._projected = np.zeros(b, np.int64)  # dispatched tokens per slot
        self._log = log_fn or (lambda *a: None)

    # ------------------------------------------------------------------

    def register_request(self, prompt_tokens: Sequence[int],
                         config: Optional[GenerationConfig] = None) -> int:
        config = config or GenerationConfig()
        if len(prompt_tokens) >= self.engine.max_seq_len:
            raise ValueError(f"prompt length {len(prompt_tokens)} >= max_seq_len "
                             f"{self.engine.max_seq_len}")
        if config.adapter_id >= self.engine.num_adapters:
            raise ValueError(f"adapter_id {config.adapter_id}: the engine holds "
                             f"{self.engine.num_adapters} adapters")
        req = Request(guid=next(self._guid), prompt_tokens=list(prompt_tokens), config=config)
        req.profile.registration_time = time.monotonic()
        self._requests[req.guid] = req
        self._pending.put(req)
        return req.guid

    def get_request(self, guid: int) -> Request:
        return self._requests[guid]

    def register_finetune(self, session) -> None:
        """Co-scheduled LoRA finetuning (JAX ``register_finetune``) needs a
        backward pass through the decoder: it comes with the training slice."""
        raise NotImplementedError(
            "co-scheduled LoRA finetuning is not in the port yet: it waits for the training "
            "slice (ROADMAP.md Queue A, A5b)")

    def _next_key(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._gen))

    def _admit(self) -> None:
        """Fill free slots from the pending queue (one batched prefill; prompts
        over the chunked-prefill budget go one by one)."""
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
            self._slots[slot] = req
            self._cache_lens[slot] = len(req.prompt_tokens)
            self._projected[slot] = 1
            self._temperature[slot] = req.config.temperature
            self._top_p[slot] = req.config.top_p
            self._top_k[slot] = req.config.top_k
            self._adapter[slot] = req.config.adapter_id
            self._log(f"[RM] admit guid={req.guid} slot={slot} "
                      f"prompt_len={len(req.prompt_tokens)}")
            admits.append((slot, req))
        if not admits:
            return

        budget = self.engine.max_tokens_per_batch
        chunked = [(s, r) for s, r in admits if budget and len(r.prompt_tokens) > budget]
        batched = [(s, r) for s, r in admits if (s, r) not in chunked]

        results = []  # (slot, req, device token)
        if batched:
            scfg = SamplingConfig(
                temperature=np.array([r.config.temperature for _, r in batched], np.float32),
                top_p=np.array([r.config.top_p for _, r in batched], np.float32),
                top_k=np.array([r.config.top_k for _, r in batched], np.int32),
            )
            toks = self.engine.prefill_batch_to_slots_async(
                [np.asarray(r.prompt_tokens, np.int32) for _, r in batched],
                [s for s, _ in batched], self._next_key(), scfg,
                adapter_ids=[r.config.adapter_id for _, r in batched])
            results.extend((s, r, toks[i]) for i, (s, r) in enumerate(batched))
        for slot, req in chunked:
            scfg1 = SamplingConfig(
                temperature=np.array([req.config.temperature], np.float32),
                top_p=np.array([req.config.top_p], np.float32),
                top_k=np.array([req.config.top_k], np.int32),
            )
            results.append((slot, req, self.engine.prefill_to_slot_async(
                np.asarray(req.prompt_tokens, np.int32), slot, self._next_key(), scfg1,
                adapter_id=req.config.adapter_id)))

        firsts = torch.stack([t for _, _, t in results])
        if self.pipelined:
            fut = self._fetcher.submit(self._fetch_stamped, firsts)
            self._inflight_q.append(("first", fut, list(results)))
            for slot, _, tok_dev in results:
                self._feedback_overrides.append((slot, tok_dev))
        else:
            for (slot, req, _), tok in zip(results, self.engine.fetch(firsts)):
                first_tok = int(tok)
                req.profile.first_token_time = time.monotonic()
                req.profile.llm_decoding_steps = 1
                req.output_tokens.append(first_tok)
                self._tokens[slot] = first_tok
                self._feedback_overrides.append((slot, first_tok))
                if self._finished(req, first_tok):
                    self._retire(slot)

    def _finished(self, req: Request, last_token: int) -> bool:
        if last_token in self.eos_token_ids or last_token in tuple(req.config.stop_token_ids):
            return True
        if len(req.output_tokens) >= req.config.max_new_tokens:
            return True
        return len(req.prompt_tokens) + len(req.output_tokens) >= self.engine.max_seq_len

    def _retire(self, slot: int) -> None:
        req = self._slots[slot]
        req.state = COMPLETED
        req.profile.finish_time = time.monotonic()
        self._slots[slot] = None
        self._cache_lens[slot] = 0
        self._projected[slot] = 0
        self._adapter[slot] = -1
        self._num_processed += 1
        self._log(f"[Profile] guid({req.guid}) llm_decoding_steps("
                  f"{req.profile.llm_decoding_steps}) latency({req.profile.latency * 1e3:.3f}) "
                  f"ttft({req.profile.ttft * 1e3:.3f})")
        req.done.set()

    def _process_horizon(self, out_tokens: np.ndarray, entries) -> None:
        """Apply one fetched [n, B] horizon to the requests it was run for."""
        for slot, req in entries:
            if req.state == COMPLETED:
                continue
            for i in range(out_tokens.shape[0]):
                tok = int(out_tokens[i, slot])
                req.output_tokens.append(tok)
                req.profile.llm_decoding_steps += 1
                if self._finished(req, tok):
                    self._retire(slot)
                    break

    def _fetch_stamped(self, x):
        """Fetch on the worker and note when the values reached the host:
        the first-token time, however late the scheduler applies them."""
        vals = self.engine.fetch(x)
        return vals, time.monotonic()

    def _process_first(self, fetched, pend) -> None:
        vals, now = fetched
        for (slot, req, _), tok in zip(pend, vals):
            tok = int(tok)
            req.profile.first_token_time = now
            req.profile.llm_decoding_steps = 1
            req.output_tokens.append(tok)
            if self._finished(req, tok):
                self._retire(slot)

    def _choose_horizon(self, active, *, projected: bool = False) -> int:
        """Power-of-two horizon covering the largest remaining budget (token
        budget and cache room) of the active slots, capped at decode_horizon;
        with ``projected`` in-flight work counts and 0 means skip."""
        rem = 0
        for s in active:
            req = self._slots[s]
            done = int(self._projected[s]) if projected else len(req.output_tokens)
            room = self.engine.max_seq_len - (len(req.prompt_tokens) + done)
            rem = max(rem, min(req.config.max_new_tokens - done, room))
        if rem <= 0:
            return 0 if projected else 1
        n = 1
        while n < rem:
            n *= 2
        return max(1, min(n, self.decode_horizon))

    def _apply_fetched(self, kind: str, out, entries) -> None:
        if kind == "first":
            self._process_first(out, entries)
        else:
            self._process_horizon(out, entries)

    def _step_pipelined(self) -> bool:
        while self._inflight_q and self._inflight_q[0][1].done():
            kind, fut, entries = self._inflight_q.pop(0)
            self._apply_fetched(kind, fut.result(), entries)
        self._admit()
        active = [s for s in range(self.engine.max_requests) if self._slots[s]]

        n = self._choose_horizon(active, projected=True) if active else 0
        if active and n > 0:
            scfg = SamplingConfig(temperature=self._temperature, top_p=self._top_p,
                                  top_k=self._top_k)
            if self._feedback is not None:
                tokens_in = self._feedback.clone()
            else:
                tokens_in = torch.as_tensor(self._tokens).to(self.engine.device)
            for slot, tok in self._feedback_overrides:
                tokens_in[slot] = tok
            self._feedback_overrides = []
            lens = self._cache_lens.copy()
            out_dev = self.engine.decode_horizon_async(
                lens, tokens_in, self._next_key(), scfg, n, adapter_ids=self._adapter)
            entries = [(s, self._slots[s]) for s in active]
            for s in active:
                self._cache_lens[s] += n
                self._projected[s] += n
            self._feedback = out_dev[-1]
            fut = self._fetcher.submit(self.engine.fetch, out_dev)
            self._inflight_q.append(("horizon", fut, entries))
            self._steps += n

        def horizons_in_flight():
            return sum(1 for k, _, _ in self._inflight_q if k == "horizon")

        while self._inflight_q and (horizons_in_flight() >= self.pipeline_depth
                                    or not active or n == 0):
            kind, fut, entries = self._inflight_q.pop(0)
            self._apply_fetched(kind, fut.result(), entries)
            if active and n > 0 and kind == "horizon":
                break
        return bool(active or self._inflight_q)

    def step(self) -> bool:
        """One scheduling iteration; True while any request is in flight."""
        if self.pipelined and self.decode_horizon > 1:
            return self._step_pipelined()
        self._admit()
        active = [s for s in range(self.engine.max_requests) if self._slots[s]]
        if not active:
            return False
        scfg = SamplingConfig(temperature=self._temperature, top_p=self._top_p,
                              top_k=self._top_k)
        n = self._choose_horizon(active) if self.decode_horizon > 1 else 1
        if n == 1:
            horizon_tokens = self.engine.decode(
                self._cache_lens, self._tokens, self._next_key(), scfg,
                adapter_ids=self._adapter)[None, :]
        else:
            horizon_tokens = self.engine.decode_horizon(
                self._cache_lens, self._tokens, self._next_key(), scfg, n,
                adapter_ids=self._adapter)
        self._steps += n
        for slot in active:
            req = self._slots[slot]
            for i in range(n):
                tok = int(horizon_tokens[i, slot])
                req.output_tokens.append(tok)
                req.profile.llm_decoding_steps += 1
                if self._finished(req, tok):
                    self._retire(slot)
                    break
            else:
                self._cache_lens[slot] += n
                self._tokens[slot] = int(horizon_tokens[n - 1, slot])
        return True

    # ------------------------------------------------------------------

    def run_until_idle(self) -> None:
        while self.step() or not self._pending.empty():
            pass

    def generate(
        self,
        prompts: Union[Sequence[int], Sequence[Sequence[int]]],
        config: Optional[GenerationConfig] = None,
    ) -> List[Request]:
        """Synchronous batch generate (token-id interface)."""
        if prompts and isinstance(prompts[0], int):
            prompts = [prompts]
        guids = [self.register_request(p, config) for p in prompts]
        self.run_until_idle()
        return [self._requests[g] for g in guids]

    def close(self) -> None:
        """Stop the fetch worker thread."""
        self._fetcher.shutdown(wait=True)

    @property
    def num_processed_requests(self) -> int:
        return self._num_processed

    @property
    def total_decoding_steps(self) -> int:
        return self._steps
