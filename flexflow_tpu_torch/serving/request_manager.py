"""RequestManager — continuous-batching scheduler (port of
``flexflow_tpu/serving/request_manager.py``).

Slot-based continuous batching over an :class:`InferenceEngine`: requests
are admitted into free slots (batched prefill), decoded in horizons of up to
``decode_horizon`` steps, and retired on EOS, stop tokens, their token budget
or a full cache. With ``pipelined=True`` horizon k+1 is dispatched before
horizon k's tokens are fetched; the fetch (``.cpu()``) runs on a worker
thread. Outputs are identical either way.

``jax.random`` keys become one ``torch.Generator`` that draws a 63-bit step
key per dispatch (see ``ops/sampling``). Every fetched batch of tokens
(first tokens, stepwise and pipelined horizons) is applied by the native
scheduler core (``utils/native_scheduler``, built from
``native/scheduler_core.cc``), as the JAX package applies its pipelined
horizons. Each slot carries its request's LoRA adapter id (-1: none) into
every prefill and horizon, as in JAX.

``start_background_server`` runs ``step()`` on a thread of its own (a 1 ms
sleep when idle) while other threads register requests and wait on their
``done`` events; only that thread touches the device. If the loop raises,
every request not yet done is marked ``FAILED`` with the error and leaves
its slot, ``generate`` raises, and new registrations are refused until the
server is stopped or started again (``BackgroundServing``, shared with
``SpecRequestManager``). ``--profiling`` (``FFConfig.profiling``) times the
scheduler's phases and prints their report, and the per-op profile once,
when ``run_until_idle`` drains. ``register_finetune`` queues LoRA
finetuning sessions (``peft/finetune.py``): ``run_until_idle`` runs one
step of the first after every scheduling iteration, as JAX does, on the
engine's stream behind the horizons already dispatched; the background
server does not run them (nor does JAX's).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import itertools
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from flexflow_tpu_torch.config import config as _ffconfig
from flexflow_tpu_torch.ops.sampling import SamplingConfig
from flexflow_tpu_torch.serving.engine import InferenceEngine
from flexflow_tpu_torch.utils import native_scheduler
from flexflow_tpu_torch.utils.profiling import StepTimer, per_op_profile


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


PENDING, RUNNING, COMPLETED, FAILED = ("PENDING", "RUNNING", "COMPLETED", "FAILED")


@dataclasses.dataclass
class Request:
    guid: int
    prompt_tokens: List[int]
    config: GenerationConfig
    state: str = PENDING
    slot: int = -1
    error: Optional[str] = None  # set when the serving loop died (FAILED)
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    profile: ProfileInfo = dataclasses.field(default_factory=ProfileInfo)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)

    @property
    def tokens(self) -> List[int]:
        return self.prompt_tokens + self.output_tokens


class BackgroundServing:
    """The background serving loop of a request manager (``RequestManager``
    and ``SpecRequestManager``): ``step()`` on a thread of its own while
    other threads register requests and wait on their ``done`` events.

    The manager provides ``engine``, ``step()``, ``run_until_idle()``,
    ``_pending`` (a queue), ``_requests`` (guid -> Request) and
    ``_drop_inflight()`` (empties its slots and in-flight work), and calls
    ``_init_server()`` in its constructor and ``_enqueue`` to register."""

    def _init_server(self) -> None:
        self._lock = threading.Lock()  # _requests: registering threads vs the failing loop
        self._server_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._failure: Optional[str] = None  # the error the last loop died of

    def _enqueue(self, req: Request) -> int:
        req.profile.registration_time = time.monotonic()
        with self._lock:
            if self._failure is not None:
                # nothing would ever serve it: refuse instead of leaving the caller waiting
                raise RuntimeError(f"serving loop failed: {self._failure}")
            self._requests[req.guid] = req
        self._pending.put(req)
        return req.guid

    def finish(self, guids: Sequence[int]) -> List[Request]:
        """The requests ``guids`` once done: awaited while the background
        server runs, else served here by ``run_until_idle``. Raises
        ``RuntimeError`` when the serving loop died under one of them
        (partial output is not returned as if complete)."""
        if self._server_thread is None:
            self.run_until_idle()
        else:
            for g in guids:
                self._requests[g].done.wait()
        reqs = [self._requests[g] for g in guids]
        failed = next((r for r in reqs if r.state == FAILED), None)
        if failed is not None:
            raise RuntimeError(f"serving loop failed during generation: {failed.error}")
        return reqs

    def start_background_server(self) -> None:
        """Run ``step()`` on a daemon thread, sleeping 1 ms when idle
        (idempotent). On the card the thread runs under the engine's device
        (the current device is per thread). If a step raises, every request
        not yet done is failed and the exception is re-raised on the thread."""
        if self._server_thread is not None:
            return
        self._stop.clear()
        self._failure = None
        device = self.engine.device

        def loop():
            try:
                with (torch.cuda.device(device) if device.type == "cuda"
                      else contextlib.nullcontext()):
                    while not self._stop.is_set():
                        if not self.step() and self._pending.empty():
                            time.sleep(0.001)
            except BaseException as e:
                self._fail_all_inflight(e)
                # a restarted loop serves new requests, not the failed ones
                self._drop_inflight()
                raise

        self._server_thread = threading.Thread(target=loop, daemon=True)
        self._server_thread.start()

    def _fail_all_inflight(self, exc: BaseException) -> None:
        """Unblock every waiter when the serving loop dies: requests not yet
        done become FAILED with the error recorded, and later registrations
        are refused until the server is stopped or started again."""
        with self._lock:
            self._failure = f"{type(exc).__name__}: {exc}"
            for req in self._requests.values():
                if not req.done.is_set():
                    req.state = FAILED
                    req.error = self._failure
                    req.done.set()

    def stop_server(self) -> None:
        """Stop the loop between two steps and join it. Work still in flight
        (pipelined horizons) stays queued for the next ``step()``, from a
        restarted server or an in-process ``generate``."""
        if self._server_thread is None:
            return
        self._stop.set()
        self._server_thread.join()
        self._server_thread = None
        self._failure = None  # generate() serves in-process again


class RequestManager(BackgroundServing):
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
        self.timer = StepTimer() if _ffconfig.profiling else None
        self._per_op_printed = False
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self._inflight_q = []  # [(kind, fetch future, entries), ...]
        self._fetcher = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._feedback = None  # device [B] tokens from the last dispatch
        self._feedback_overrides = []  # [(slot, token)] set at admit time
        self.eos_token_ids = tuple(eos_token_ids) or engine.spec.eos_ids()
        self._guid = itertools.count(1000000)
        self._pending: "queue.Queue[Request]" = queue.Queue()
        self._requests: Dict[int, Request] = {}
        self._finetune_queue = []  # co-scheduled LoRA finetuning sessions
        self._init_server()

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
        return self._enqueue(req)

    def get_request(self, guid: int) -> Request:
        return self._requests[guid]

    def register_finetune(self, session) -> None:
        """Queue a LoRA finetuning session (``peft/finetune.FinetuneSession``)
        to run alongside serving, one step per ``run_until_idle`` iteration."""
        self._finetune_queue.append(session)

    def _finetune_tick(self) -> bool:
        if not self._finetune_queue:
            return False
        if self._finetune_queue[0].tick(self.engine):
            self._finetune_queue.pop(0)
        return True

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
            vals = self.engine.fetch(firsts)
            for (slot, _, _), tok in zip(results, vals):
                self._tokens[slot] = int(tok)
                self._feedback_overrides.append((slot, int(tok)))
            self._process_first((vals, time.monotonic()), results)

    def _retire(self, slot: int) -> None:
        req = self._slots[slot]
        req.state = COMPLETED
        req.profile.finish_time = time.monotonic()
        self._slots[slot] = None
        self._cache_lens[slot] = 0
        self._projected[slot] = 0
        self._adapter[slot] = -1
        # a retired slot samples nothing: left at its request's settings it
        # would keep every later all-greedy horizon off the replay path
        self._temperature[slot] = 0.0
        self._top_p[slot] = 1.0
        self._top_k[slot] = 0
        self._num_processed += 1
        self._log(f"[Profile] guid({req.guid}) llm_decoding_steps("
                  f"{req.profile.llm_decoding_steps}) latency({req.profile.latency * 1e3:.3f}) "
                  f"ttft({req.profile.ttft * 1e3:.3f})")
        req.done.set()

    def _process_horizon(self, out_tokens: np.ndarray, entries) -> np.ndarray:
        """Apply fetched [n, B] tokens to the requests they were run for and
        return which slots finished ([B]). The native scheduler core
        (``utils/native_scheduler``, as in the JAX package) is the one
        retirement rule of every path (first tokens, stepwise and pipelined
        horizons): a slot takes tokens until an EOS or stop id, its max-new
        tokens, or a full cache; finished slots retire through ``_retire``."""
        b = self.engine.max_requests
        fin = np.zeros(b, np.int32)
        live = [(s, r) for s, r in entries if r.state != COMPLETED]
        if not live:
            return fin
        active = np.zeros(b, np.int32)
        counts = np.zeros(b, np.int32)
        max_new = np.full(b, 1 << 30, np.int32)
        totals = np.zeros(b, np.int32)
        budget = np.full(b, 1 << 30, np.int32)
        max_stop = max([len(tuple(r.config.stop_token_ids)) for _, r in live] + [1])
        stop_ids = np.full((b, max_stop), -1, np.int32)
        stop_counts = np.zeros(b, np.int32)
        for s, r in live:
            active[s] = 1
            counts[s] = len(r.output_tokens)
            max_new[s] = r.config.max_new_tokens
            totals[s] = len(r.prompt_tokens) + len(r.output_tokens)
            budget[s] = self.engine.max_seq_len
            sids = tuple(r.config.stop_token_ids)
            stop_counts[s] = len(sids)
            stop_ids[s, :len(sids)] = sids
        eos = np.asarray(list(self.eos_token_ids) or [-1], np.int32)
        # margin 1: a slot retires once its cache is full (total >= S)
        toks, taken, fin = native_scheduler.process_horizon(
            np.asarray(out_tokens, np.int32), active, counts, max_new, totals, budget, 1, eos,
            stop_ids, stop_counts)
        for s, r in live:
            k = int(taken[s])
            r.output_tokens.extend(int(x) for x in toks[s, :k])
            r.profile.llm_decoding_steps += k
            if fin[s]:
                self._retire(s)
        return fin

    def _fetch_stamped(self, x):
        """Fetch on the worker and note when the values reached the host:
        the first-token time, however late the scheduler applies them."""
        vals = self.engine.fetch(x)
        return vals, time.monotonic()

    def _process_first(self, fetched, pend) -> None:
        """Apply the prefills' first tokens (fetched at ``now``) as a
        one-token horizon."""
        vals, now = fetched
        first = np.zeros((1, self.engine.max_requests), np.int32)
        for (slot, req, _), tok in zip(pend, vals):
            first[0, slot] = int(tok)
            req.profile.first_token_time = now
        self._process_horizon(first, [(slot, req) for slot, req, _ in pend])

    def _phase(self, name: str):
        return contextlib.nullcontext() if self.timer is None else self.timer.phase(name)

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
        with self._phase("admit"):
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
            with self._phase("decode_dispatch"):
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
            with self._phase("horizon_fetch"):
                out = fut.result()
            self._apply_fetched(kind, out, entries)
            if active and n > 0 and kind == "horizon":
                break
        return bool(active or self._inflight_q)

    def step(self) -> bool:
        """One scheduling iteration; True while any request is in flight."""
        if self.pipelined and self.decode_horizon > 1:
            return self._step_pipelined()
        with self._phase("admit"):
            self._admit()
        active = [s for s in range(self.engine.max_requests) if self._slots[s]]
        if not active:
            return False
        scfg = SamplingConfig(temperature=self._temperature, top_p=self._top_p,
                              top_k=self._top_k)
        n = self._choose_horizon(active) if self.decode_horizon > 1 else 1
        with self._phase("decode"):
            if n == 1:
                horizon_tokens = self.engine.decode(
                    self._cache_lens, self._tokens, self._next_key(), scfg,
                    adapter_ids=self._adapter)[None, :]
            else:
                horizon_tokens = self.engine.decode_horizon(
                    self._cache_lens, self._tokens, self._next_key(), scfg, n,
                    adapter_ids=self._adapter)
        self._steps += n
        fin = self._process_horizon(horizon_tokens, [(s, self._slots[s]) for s in active])
        for slot in active:
            if not fin[slot]:
                self._cache_lens[slot] += n
                self._tokens[slot] = int(horizon_tokens[n - 1, slot])
        return True

    # ------------------------------------------------------------------

    def _drop_inflight(self) -> None:
        for slot in range(self.engine.max_requests):
            if self._slots[slot] is not None:
                self._slots[slot] = None
                self._cache_lens[slot] = self._projected[slot] = 0
                self._temperature[slot], self._top_p[slot], self._top_k[slot] = 0.0, 1.0, 0
                self._adapter[slot] = -1
        self._inflight_q, self._feedback, self._feedback_overrides = [], None, []

    def run_until_idle(self) -> None:
        while True:
            busy = self.step()
            busy |= self._finetune_tick()
            if not busy and self._pending.empty():
                break
        if self.timer is not None:
            for line in self.timer.report():
                print(line)
            # the per-op profile once per manager, at the first drain
            if not self._per_op_printed:
                self._per_op_printed = True
                if type(self.engine) is InferenceEngine:
                    for line in per_op_profile(self.engine.spec, self.engine.params):
                        print(line)

    def generate(
        self,
        prompts: Union[Sequence[int], Sequence[Sequence[int]]],
        config: Optional[GenerationConfig] = None,
    ) -> List[Request]:
        """Synchronous batch generate (token-id interface); see
        :meth:`BackgroundServing.finish`."""
        if prompts and isinstance(prompts[0], int):
            prompts = [prompts]
        return self.finish([self.register_request(p, config) for p in prompts])

    def close(self) -> None:
        """Stop the server, if running, and the fetch worker thread."""
        self.stop_server()
        self._fetcher.shutdown(wait=True)

    @property
    def num_processed_requests(self) -> int:
        return self._num_processed

    @property
    def total_decoding_steps(self) -> int:
        return self._steps


