"""PipelineInferenceEngine — pipeline-parallel serving over the ``pipe``
stages of a ``parallel/mesh.Mesh`` (port of
``flexflow_tpu/serving/pp_engine.py``).

JAX runs one controller: the layers and the KV cache are stage-stacked
``[P, L/P, ...]`` and sharded on ``pipe``, and one ``shard_map`` over
``("pipe", "model")`` scans M + P - 1 ticks, rotating activations with
``ppermute``. The port runs one process per rank (SPMD) and gives the same
results:

- each rank holds only its own stage's ``[L/P, ...]`` layers
  (``parallel/sharding.shard_params`` under the mesh's ``pipe`` axis) and
  its own ``[L/P, B, KH_local, S, D]`` KV cache; stage 0 holds the
  embeddings, the last stage the final norm and ``lm_head`` (JAX
  replicates those top leaves on every stage);
- the request slots split into M microbatches (``num_microbatches``,
  default P) of ``B / M`` rows, and each rank loops over them: the hidden
  state comes from the stage before (``Mesh.recv_prev``; stage 0 embeds
  tokens), the stage's layers run through the one-device decoder
  (``decoder.forward`` / ``forward_cached`` with ``hidden=`` / ``head=``,
  so its projections, its T = 1 decode steps and its prefills launch the
  same kernels one device does) and the result goes on to the stage after
  (``Mesh.send_next``). The ticks of JAX's scan are each rank's loop order;
  a send never waits for its receiver, so a stage runs ahead as far as its
  inputs allow;
- each microbatch's K/V is written straight into the stage's cache rows,
  as ``forward_cached`` does on one device: JAX's staging buffer, committed
  once a step, is a TPU choice the port does not carry over;
- the last stage unembeds and samples; its tokens are broadcast over the
  ``pipe`` group, so every rank returns the same values and the
  ``RequestManager`` runs identically on every rank. A sampled row draws
  with its global slot index and the step's ``fold_in(key, i)``, as
  ``InferenceEngine`` does, so a sampled run gives the one-device port's
  draws bit for bit;
- tensor parallelism composes inside each stage (``pipe x model``: each
  stage's layers cut over its ``model`` ranks, ``parallel/sharding``), as
  does LoRA at T = 1 (the stage's slices of the adapter stacks);
- under a context degree (``pipe x seq``) each seq coordinate runs its own
  copy of the stage schedule over its own pipe group and stage hops, and
  every stage holds its whole cache on each seq rank: JAX's ``shard_map``
  runs over ``("pipe", "model")`` only and its cache spec has no ``seq``
  entry, so its GSPMD replicates the pipeline over ``seq``.

Modes, as in JAX: batched prefill over a fixed ``max_requests`` rows
(padding rows write nothing; a microbatch of padding only is skipped on
every rank), chunked prefill under ``max_tokens_per_batch`` (one row per
chunk through the stages, the final window clipped at the cache end),
stepwise decode horizons when M < P (every step's tokens broadcast before
the next step) and the overlapped horizon when M >= P: the last stage
sends each microbatch's sampled token back to stage 0
(``Mesh.send_first``), which embeds it for that microbatch's next step;
with M > P the tokens arrive ahead of their use and wait in the hop.

Adapter ids reach every call, the horizon and the single-slot prefill
included (JAX's ``decode_horizon`` and ``prefill_to_slot`` drop them).

The engine captures no CUDA graph (``graphs`` is None): every horizon runs
eagerly. Under gloo nothing could be captured; capturing a stage's step
under NCCL is a speed item (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from flexflow_tpu_torch.config import config as _ffconfig
from flexflow_tpu_torch.device import resolve_device
from flexflow_tpu_torch.models import decoder
from flexflow_tpu_torch.models.decoder import KVCache, to_device
from flexflow_tpu_torch.ops import sampling as sampling_lib
from flexflow_tpu_torch.ops.sampling import SamplingConfig
from flexflow_tpu_torch.parallel.pipeline import stage_params, stage_range
from flexflow_tpu_torch.parallel.sharding import shard_params, tree_shard
from flexflow_tpu_torch.peft.lora import lora_scaling, route_lora
from flexflow_tpu_torch.serving.engine import _params_to, _round_up_pow2, refuse_expert_cut
from flexflow_tpu_torch.specs import ModelSpec


class PipelineInferenceEngine:
    """The ``InferenceEngine`` surface over the pipeline stages of ``mesh``
    (this rank's stage); every rank of the mesh is driven with the same
    calls and the same host values."""

    graphs = None  # no CUDA graph: every horizon runs eagerly

    def __init__(
        self,
        spec: ModelSpec,
        params,
        *,
        mesh,  # parallel/mesh.Mesh with the pipe axis (data must be 1)
        max_requests_per_batch: int = 8,
        max_seq_len: int = 256,
        max_tokens_per_batch: int = 0,  # > 0 enables chunked prefill
        min_prefill_bucket: int = 16,
        cache_dtype=torch.bfloat16,
        num_microbatches: Optional[int] = None,  # default: the stage count
        lora=None,  # {mod: {"a": [L, N, D_in, r], "b": [L, N, r, D_out]}}, whole or the stage's
        lora_config=None,
        device=None,
    ):
        if mesh.data != 1:
            # the reference asserts data_parallelism_degree == 1 when serving
            raise NotImplementedError("pipeline-parallel serving requires data axis == 1")
        self.pp, self.tp = mesh.pipe, mesh.model
        lo, hi = stage_range(spec.num_layers, self.pp, mesh.pipe_rank)
        m = num_microbatches or self.pp
        if max_requests_per_batch % m:
            raise ValueError(f"batch {max_requests_per_batch} not divisible by microbatches {m}")
        if lora is not None and self.tp > 1:
            raise NotImplementedError("LoRA under pipeline parallelism requires "
                                      "tensor_parallelism_degree == 1")
        refuse_expert_cut(spec, params)
        self.spec, self.mesh = spec, mesh
        self.device = resolve_device(mesh.device if device is None else device)
        self.stage, self.first, self.last = mesh.pipe_rank, mesh.first_stage, mesh.last_stage
        self.layers = (lo, hi)
        self.num_microbatches = m
        self.max_requests = max_requests_per_batch
        self.max_seq_len = max_seq_len
        self.max_tokens_per_batch = int(max_tokens_per_batch)
        self.min_prefill_bucket = min_prefill_bucket
        # the stage's layers and top leaves; the model axis cut where T > 1
        # (at T = 1 the stage runs the one-device layers, no collective)
        shard = tree_shard(spec, params, mesh)
        params = _params_to(shard_params(spec, params, mesh), self.device)
        self.shard = shard if self.tp > 1 else None
        if _ffconfig.fuse_qkv:
            params = decoder.fuse_qkv_params(spec, params, self.shard)
        self.params = params
        self.act_dtype = params["layers"]["ln1_scale"].dtype  # the hidden state's, on every hop
        if lora is not None:
            lora = _params_to(lora, self.device)
            depth = next(iter(lora.values()))["a"].shape[0]
            if depth == spec.num_layers:  # a whole stack: the stage's slices
                lora = stage_params(lora, self.pp, self.stage)
        self.lora = None if lora is None else route_lora(lora)
        self.lora_scale = lora_scaling(lora_config) if lora is not None and lora_config else 1.0
        self.num_adapters = 0 if lora is None else self.lora.num_adapters
        self.cache = decoder.init_kv_cache(
            spec, max_requests_per_batch, max_seq_len, cache_dtype, self.device,
            num_kv_heads=None if self.shard is None else self.shard.num_kv_cache(spec),
            num_layers=hi - lo)
        bm = max_requests_per_batch // m
        self._rows = [slice(j * bm, (j + 1) * bm) for j in range(m)]
        self._mb_cache = [KVCache(self.cache.k[:, r], self.cache.v[:, r]) for r in self._rows]

    # ------------------------------------------------------------------

    def fetch(self, x) -> np.ndarray:
        """Device -> host (waits for the device)."""
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def prefill_bucket(self, prompt_len: int) -> int:
        return min(_round_up_pow2(max(prompt_len, 1), self.min_prefill_bucket),
                   self.max_seq_len)

    def attn_window_bucket(self, max_len: int):
        """The full cache, as JAX's pipeline engine reads it (the decode
        kernel reads only committed positions anyway)."""
        return None

    @staticmethod
    def _greedy_only(scfg: SamplingConfig) -> bool:
        return bool(np.all(np.asarray(scfg.temperature) <= 0.0))

    def _scfg(self, scfg: SamplingConfig, rows=slice(None)) -> SamplingConfig:
        return SamplingConfig(*(torch.as_tensor(np.asarray(f, dt)[rows]).to(self.device)
                                for f, dt in zip(scfg, (np.float32, np.float32, np.int32))))

    def _sample(self, logits, key: int, scfg: SamplingConfig, rows: range):
        """One token per row of ``logits`` ([R, V]), the rows ``rows`` of
        the batch ``scfg`` describes (their indices seed sampled rows)."""
        sub = slice(rows.start, rows.stop)
        if self._greedy_only(SamplingConfig(*(np.asarray(f)[sub] for f in scfg))):
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return sampling_lib.sample(logits, key, self._scfg(scfg, sub), rows=rows)

    def _adapter_ids(self, adapter_ids: Optional[Sequence[int]], n: int) -> np.ndarray:
        ids = (np.full(n, -1, np.int64) if adapter_ids is None
               else np.asarray(adapter_ids, np.int64).reshape(n))
        if np.any(ids >= self.num_adapters):
            raise ValueError(f"adapter ids {ids.tolist()}: the engine holds "
                             f"{self.num_adapters} adapters")
        return ids

    def _routing(self, ids: np.ndarray) -> dict:
        """The decoder's rank and LoRA arguments for rows routed to ``ids``."""
        kw = {} if self.shard is None else dict(shard=self.shard)
        if self.lora is None:
            return kw
        return dict(kw, lora=self.lora, adapter_ids=to_device(ids, self.device, np.int64),
                    lora_scale=self.lora_scale)

    def _tokens_in(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=torch.int32)
        return to_device(tokens, self.device)

    def _stage(self, run, shape) -> Optional[torch.Tensor]:
        """This stage's part of one microbatch: ``run(hidden)`` on the hidden
        state of ``shape`` from the stage before (None on stage 0), its
        output sent on to the stage after; returned on the last stage."""
        h = None
        if not self.first:
            h = self.mesh.recv_prev(torch.empty(shape, dtype=self.act_dtype, device=self.device))
        out = run(h)
        if self.last:
            return out
        self.mesh.send_next(out)
        return None

    def _finish(self, out: torch.Tensor) -> torch.Tensor:
        """The last stage's ``out`` on every rank, once this rank's hops are
        through."""
        self.mesh.wait_sends()
        return self.mesh.broadcast_from_stage(out, self.pp - 1)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def prefill_batch_to_slots_async(self, prompts, slots, key: int, scfg: SamplingConfig,
                                     adapter_ids=None) -> torch.Tensor:
        """Admit up to ``max_requests`` prompts in one pass of fixed
        ``max_requests`` rows (padding rows carry slot -1 and write
        nothing); returns the [NB] device first tokens."""
        real_nb, nb = len(prompts), self.max_requests
        if real_nb > nb:
            raise ValueError(f"{real_nb} prompts for {nb} request slots")
        bucket = max(self.prefill_bucket(len(p)) for p in prompts)
        padded = np.zeros((nb, bucket), np.int32)
        lengths = np.ones((nb,), np.int32)
        slot_arr = np.full((nb,), -1, np.int64)
        for i, p in enumerate(prompts):
            if len(p) > self.max_seq_len:
                raise ValueError(f"prompt length {len(p)} exceeds max_seq_len {self.max_seq_len}")
            padded[i, :len(p)] = p
            lengths[i] = len(p)
            slot_arr[i] = slots[i]
        pad = nb - real_nb
        scfg = SamplingConfig(
            temperature=np.pad(np.asarray(scfg.temperature, np.float32), (0, pad)),
            top_p=np.pad(np.asarray(scfg.top_p, np.float32), (0, pad), constant_values=1.0),
            top_k=np.pad(np.asarray(scfg.top_k, np.int32), (0, pad)))
        ids = self._adapter_ids(None if adapter_ids is None else
                                list(adapter_ids) + [-1] * pad, nb)
        out = torch.zeros(nb, dtype=torch.int32, device=self.device)
        positions = torch.arange(bucket, dtype=torch.int32, device=self.device)
        with torch.no_grad():
            for r in self._rows:
                if np.all(slot_arr[r] < 0):  # padding only: skipped on every rank
                    continue
                lens = to_device(lengths[r], self.device)
                pos = positions[None].expand(r.stop - r.start, bucket)
                starts, mb_slots = np.zeros(r.stop - r.start, np.int64), slot_arr[r]

                def sink(layer, k, v):  # [bm, T, KH, D] -> the admitted slots' rows
                    decoder.commit_kv_windows(
                        self.cache.k[layer:layer + 1], self.cache.v[layer:layer + 1],
                        k.permute(0, 2, 1, 3)[None].to(self.cache.k.dtype),
                        v.permute(0, 2, 1, 3)[None].to(self.cache.v.dtype), starts, mb_slots)

                def run(h):
                    res, _ = decoder.forward(
                        self.spec, self.params,
                        to_device(padded[r], self.device) if h is None else None, pos,
                        lengths=lens, flash=True, kv_sink=sink,
                        logits_at=lens - 1 if self.last else None, hidden=h, head=self.last,
                        first_layer=self.layers[0], **self._routing(ids[r]))
                    return res

                logits = self._stage(run, (r.stop - r.start, bucket, self.spec.hidden_size))
                if self.last:
                    out[r] = self._sample(logits, key, scfg, range(r.start, r.stop))
            return self._finish(out)[:real_nb]

    def prefill_to_slot_async(self, prompt_tokens, slot: int, key: int, scfg1: SamplingConfig,
                              adapter_id: int = -1) -> torch.Tensor:
        """Prefill one request into ``slot``; returns its first token as a
        device scalar. Prompts over the chunked-prefill budget go in chunks."""
        n = len(prompt_tokens)
        if n > self.max_seq_len:
            raise ValueError(f"prompt length {n} exceeds max_seq_len {self.max_seq_len}")
        if self.max_tokens_per_batch and n > self.max_tokens_per_batch:
            return self._chunked_prefill_to_slot(prompt_tokens, slot, key, scfg1, adapter_id)
        return self.prefill_batch_to_slots_async(
            [prompt_tokens], [slot], key, scfg1, adapter_ids=[adapter_id])[0]

    def prefill_to_slot(self, prompt_tokens, slot: int, key: int, scfg1: SamplingConfig,
                        adapter_id: int = -1) -> int:
        return int(self.fetch(self.prefill_to_slot_async(prompt_tokens, slot, key, scfg1,
                                                          adapter_id)))

    def _chunked_prefill_to_slot(self, prompt_tokens, slot: int, key: int,
                                 scfg1: SamplingConfig, adapter_id: int = -1) -> torch.Tensor:
        """Token-budgeted prefill: chunks of ``max_tokens_per_batch``, one row
        each through the stages, against the slot's own cache rows (written
        in place; a final window past the cache end is clipped there)."""
        c, n = self.max_tokens_per_batch, len(prompt_tokens)
        routing = self._routing(self._adapter_ids([adapter_id], 1))
        cache1 = KVCache(self.cache.k[:, slot:slot + 1], self.cache.v[:, slot:slot + 1])
        tok = torch.zeros(1, dtype=torch.int32, device=self.device)
        done = 0
        with torch.no_grad():
            while done < n:
                m = min(c, n - done)
                padded = np.zeros((1, c), np.int32)
                padded[0, :m] = prompt_tokens[done:done + m]

                def run(h):
                    res, _ = decoder.forward_cached(
                        self.spec, self.params,
                        to_device(padded, self.device) if h is None else None, cache1,
                        to_device([done], self.device), write_start=[done],
                        logits_at=to_device([m - 1], self.device) if self.last else None,
                        hidden=h, head=self.last, **routing)
                    return res

                logits = self._stage(run, (1, c, self.spec.hidden_size))
                done += m
            if self.last:
                tok = self._sample(logits, key, scfg1, range(1))
            return self._finish(tok)[0]

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def decode(self, cache_lens, tokens, key: int, scfg: SamplingConfig,
               adapter_ids=None) -> np.ndarray:
        """One decode step for every slot; returns [B] host tokens."""
        return self.decode_horizon(cache_lens, tokens, key, scfg, 1, adapter_ids)[0]

    def decode_horizon(self, cache_lens, tokens, key: int, scfg: SamplingConfig, n: int,
                       adapter_ids=None) -> np.ndarray:
        """n decode steps; returns [n, B] host tokens."""
        return self.fetch(self.decode_horizon_async(cache_lens, tokens, key, scfg, n,
                                                    adapter_ids))

    def decode_horizon_async(self, cache_lens, tokens, key: int, scfg: SamplingConfig, n: int,
                             adapter_ids=None) -> torch.Tensor:
        """n decode steps through the stages (step i writes its K/V at
        ``cache_lens + i``); returns the [n, B] device tokens, the same on
        every rank. Overlapped when M >= P (each microbatch's token returns
        to stage 0 for its next step), else stepwise. ``adapter_ids`` [B]:
        each slot's LoRA adapter (None or -1: none)."""
        lens = np.asarray(cache_lens, np.int32)
        if lens.shape != (self.max_requests,):
            raise ValueError(f"cache_lens must be [{self.max_requests}], got {lens.shape}")
        ids = self._adapter_ids(adapter_ids, self.max_requests)
        routing = [self._routing(ids[r]) for r in self._rows]
        lens_d = to_device(lens, self.device)
        toks = self._tokens_in(tokens) if self.first else None
        out = torch.zeros((n, self.max_requests), dtype=torch.int32, device=self.device)
        d = self.spec.hidden_size

        def step(i: int, j: int, tok_in) -> Optional[torch.Tensor]:
            r = self._rows[j]

            def run(h):
                res, _ = decoder.forward_cached(
                    self.spec, self.params, None if h is not None else tok_in[:, None],
                    self._mb_cache[j], lens_d[r] + i, hidden=h, head=self.last, **routing[j])
                return res

            logits = self._stage(run, (r.stop - r.start, 1, d))
            if not self.last:
                return None
            out[i, r] = self._sample(logits[:, 0], sampling_lib.fold_in(key, i), scfg,
                                     range(r.start, r.stop))
            return out[i, r]

        with torch.no_grad():
            m = self.num_microbatches
            if m >= self.pp:  # overlapped: one bubble a horizon
                for idx in range(n * m):
                    i, j = divmod(idx, m)
                    r = self._rows[j]
                    tok_in = None
                    if self.first:
                        if i == 0:
                            tok_in = toks[r]
                        elif self.last:  # one stage
                            tok_in = out[i - 1, r]
                        else:  # the token the last stage sent back for this microbatch
                            tok_in = self.mesh.recv_last(out[0, r])
                    t = step(i, j, tok_in)
                    if self.last and not self.first and i < n - 1:
                        self.mesh.send_first(t)
                return self._finish(out)
            for i in range(n):  # stepwise: every step's tokens to every stage
                for j, r in enumerate(self._rows):
                    step(i, j, toks[r] if self.first else None)
                self._finish(out[i])
                toks = out[i]
            return out
