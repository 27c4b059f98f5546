"""InferenceEngine — the device-side serving steps (port of
``flexflow_tpu/serving/engine.py``, single-device path).

PyTorch runs eagerly, so the JAX engine's jitted programs become methods:

- batched admission: one causal ``forward`` over all pending prompts (padded
  to a power-of-two bucket, flash prefill), each layer's K/V written straight
  into the admitted slots, first token sampled;
- chunked prefill: prompt chunks through ``forward_cached`` against the
  slot's cache rows;
- decode and the decode horizon (``decode_n_fn``'s counterpart): n
  single-token steps. Each step writes its K/V into the cache in place at
  the device lengths and step i attends over the ``cache_lens + i``
  committed positions through the decode-attention kernel, so JAX's
  ``[L, B, n, KH, D]`` staging buffers and ``extra_kv`` are not needed. The
  cast to the cache dtype before attention keeps this equal to JAX's staged
  form.

A greedy step is one body over static device buffers (tokens and lengths,
updated in place; ``serving/graphs.py``). On the card it is captured in a
CUDA graph at the first greedy horizon, and every greedy horizon, ``decode``
included, is n replays of it, each replay's tokens copied out into a fresh
``[n, B]`` tensor. On the CPU the same body runs n times uncaptured. A
horizon with a sampled slot (temperature > 0) is not captured: it runs its
steps eagerly (``ops/sampling.sample`` reads the temperatures on the host).
Nor is any horizon of a model whose MoE FFN is the ``ragged`` form: its
expert group sizes are read on the host every layer, so such an engine
captures nothing and runs every horizon eagerly on the card. The ``dense``
MoE form (``from_hf_config``'s) has static shapes and is captured like a
dense FFN.

LoRA (JAX ``engine.py``'s ``lora=`` / ``lora_config=``): the engine holds
N adapter stacks in the decoder's routing layout (``peft/lora.route_lora``)
and every forward routes each row to its adapter id (-1: none; batched
prefill padding rows get -1). The greedy body reads the ids from a static
device buffer that ``_load`` fills, so a LoRA engine's greedy horizons are
replays too.

CPU offload (JAX ``offload=True``): the layer stack goes to a
``models/layer_store.LayerStore`` (pinned host memory, two device slots fed on
a copy stream) and every forward streams it; the embeddings, the head and
the final norm stay on the device, as do LoRA adapter stacks. Unlike JAX,
wqkv / wgu are fused before the layers are pinned (``build_params`` fuses
a ``host_layers`` stack layer by layer), so an offload engine runs the
resident engine's launches and gives its bits. Such an engine
captures no graph (``graphs.capturable``).

Host values (lengths, slots) travel to the device through pinned,
non-blocking copies, and sampled tokens stay on the device until ``fetch``,
so the host runs ahead of the card between horizons.

Tensor and data parallelism (JAX ``mesh=``): with a
``parallel/mesh.Mesh`` every rank builds the engine over its own cut of
the parameters (``parallel/sharding.shard_params``, unless the tree is one
already) and of the KV cache (its heads; its data rank's block of slots)
and is driven with the same calls and the same host values. The public
methods keep the one-device shapes: a data rank computes only its own
slots' rows (every row's bits do not depend on the rows around it) and
the tokens are gathered over the ``data`` axis, so every rank's manager
sees every slot. Each rank takes the prefill bucket of the whole batch.
The decoder's collectives run inside the greedy step, so a graph captures
them under NCCL; gloo's cannot be captured (``graphs.capturable``). LoRA
stacks are cut with the model (``sharding.shard_lora``: a column target's
``b``, a row target's ``a``) and each data rank routes its own slots; the
engine holds the rank's :class:`~flexflow_tpu_torch.parallel.sharding.Shard`
(``self.shard``) beside its tree and passes it to every forward.

Under a mesh, offload cuts, fuses and then hands the rank's layers to its
``LayerStore`` (each rank pins and streams only its cut, as JAX keeps each
layer's TP spec in pinned host memory). ``hybrid_ffn`` (JAX's) cuts the
FFN over the model and data ranks while attention stays on ``model``;
the data axis then carries the FFN, not requests, so every rank holds
every slot and computes every row (JAX shards the cache's slots on
``data``; the values agree). Expert parallelism never reaches JAX's
engine (its ``shard_params(expert_parallel=True)`` tree is re-placed by
the engine's TP rules); the port's engines refuse a tree cut that way
and take the full tree.

Context parallelism (a mesh with ``seq > 1``, alone or with ``model``
and ``data``): every seq rank holds the weights (or its ``model`` cut)
and its block of ``S / C`` positions of every slot's cache
(``sharding.with_seq``; the whole cache where ``S % C != 0``, as JAX).
The prefill is the one-device prefill on every seq rank, each keeping
its block's positions (JAX's GSPMD replicates it over ``seq``); decode
and the chunked prefill merge each layer's attention states over
``seq`` in the decoder. Under NCCL the greedy step's graph holds the seq
all-gathers; gloo's are not captured. LoRA, offload and ``hybrid_ffn``
take a context degree as they take a mesh, the cache cut on ``seq`` all
the same (JAX places its cache with ``kv_cache_sharding`` whatever the
layout): the adapter stacks are whole over ``seq`` (cut on ``model`` by
``shard_lora``) and every seq rank adds every row's deltas, since the
decoder applies them outside the attention; each seq rank pins and
streams its own copy of its cut under offload; a hybrid FFN's group is
made per seq coordinate (``parallel/mesh``), and every slot stays on
every rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from flexflow_tpu_torch.config import config as _ffconfig
from flexflow_tpu_torch.device import resolve_device
from flexflow_tpu_torch.models import decoder
from flexflow_tpu_torch.models.decoder import to_device
from flexflow_tpu_torch.ops import sampling as sampling_lib
from flexflow_tpu_torch.ops.sampling import SamplingConfig
from flexflow_tpu_torch.peft.lora import lora_scaling, route_lora
from flexflow_tpu_torch.quant.weight_only import QuantizedArray
from flexflow_tpu_torch.serving.graphs import step_graphs
from flexflow_tpu_torch.models.layer_store import LayerStore
from flexflow_tpu_torch.parallel.mesh import DATA_AXIS
from flexflow_tpu_torch.parallel.sharding import (first_position, shard_lora, shard_params,
                                                  slot_block, tree_shard, with_seq)
from flexflow_tpu_torch.specs import ModelSpec



def _round_up_pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _params_to(params, device):
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    if isinstance(params, (QuantizedArray, torch.Tensor)):
        return params.to(device)
    return params


def refuse_expert_cut(spec: ModelSpec, params) -> None:
    """Raise for a tree whose float MoE expert stacks hold fewer than the
    spec's experts (cut by ``shard_params(expert_parallel=True)``): an
    engine cuts a full tree itself, by its own rules."""
    wg = params["layers"].get("wg")
    if (spec.moe is not None and isinstance(wg, torch.Tensor)
            and wg.shape[1] != spec.moe.num_experts):
        raise ValueError(f"the expert stacks hold {wg.shape[1]} of {spec.moe.num_experts} "
                         "experts (an expert_parallel cut): pass the engine the full tree; "
                         "it cuts each rank's share itself")


def place_params(spec: ModelSpec, params, device, mesh):
    """``(tree, shard)``: the engine's tree on ``device``, this rank's cut
    under a mesh (a rank's tree, fused or not, is kept: ``shard_params`` is
    idempotent), fused (wqkv / wgu) under ``config.fuse_qkv``; and the
    rank's :class:`Shard` (None without a mesh)."""
    shard = None
    if mesh is not None:
        refuse_expert_cut(spec, params)
        shard = tree_shard(spec, params, mesh)
        params = shard_params(spec, params, mesh)
    params = _params_to(params, device)
    if _ffconfig.fuse_qkv:
        params = decoder.fuse_qkv_params(spec, params, shard)
    return params, shard


class SlotBlock:
    """A data rank's block ``[lo, hi)`` of the request slots and the
    gathers that give every rank every slot (one data rank, a slot count
    the data axis does not divide, or a data axis that carries a hybrid
    FFN: the whole batch, no collective)."""

    def __init__(self, num_slots: int, mesh, hybrid_ffn: bool = False):
        self.mesh = mesh
        self.lo, self.hi = slot_block(num_slots, mesh, hybrid_ffn)
        self.split = self.hi - self.lo < num_slots
        self.n = self.hi - self.lo

    def local(self, x):
        """Rows [lo, hi) of a [B, ...] host array or device tensor."""
        return x[self.lo:self.hi] if self.split else x

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every data rank's rows of ``x`` along ``dim``, in slot order."""
        return self.mesh.all_gather(x, dim, DATA_AXIS) if self.split else x

    def rows(self, slots) -> list:
        """The positions in ``slots`` that this rank owns."""
        return [i for i, s in enumerate(slots) if not self.split or self.lo <= s < self.hi]

    def combine(self, n: int, rows, values: Optional[torch.Tensor], device) -> torch.Tensor:
        """An [n] int32 tensor with ``values`` at ``rows`` (this rank's),
        summed over the data axis so that every rank holds every row."""
        if not self.split:
            return values
        out = torch.zeros(n, dtype=torch.int32, device=device)
        if rows:
            out[torch.as_tensor(rows, device=device)] = values.to(torch.int32)
        return self.mesh.all_reduce(out, DATA_AXIS)


class InferenceEngine:
    """Serving steps plus the device KV cache for one model."""

    def __init__(
        self,
        spec: ModelSpec,
        params,
        *,
        max_requests_per_batch: int = 8,
        max_seq_len: int = 256,
        max_tokens_per_batch: int = 0,  # > 0 enables chunked prefill
        min_prefill_bucket: int = 16,
        cache_dtype=torch.bfloat16,
        device=None,
        lora=None,  # {mod: {"a": [L, N, D_in, r], "b": [L, N, r, D_out]}}
        lora_config=None,  # its LoraConfig (alpha / rank gives the scale)
        offload: bool = False,  # layers in pinned host memory, streamed per layer
        mesh=None,  # parallel/mesh.Mesh: this rank's cut of a TP x DP mesh
        hybrid_ffn: bool = False,  # under a mesh: the FFN over model x data ranks
    ):
        if mesh is not None and mesh.pipe > 1:
            raise ValueError("a mesh with pipeline stages is served by "
                             "serving/pp_engine.PipelineInferenceEngine")
        self.spec = spec
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None or device is not None
                                     else mesh.device)
        self.offload = bool(offload)
        self.shard = None
        if mesh is not None:
            refuse_expert_cut(spec, params)
            self.shard = with_seq(tree_shard(spec, params, mesh, hybrid_ffn=hybrid_ffn),
                                  max_seq_len)
            params = shard_params(spec, params, mesh, hybrid_ffn=hybrid_ffn)
        if self.offload:  # the layers stay where they are until the store takes them
            params = {**_params_to({k: v for k, v in params.items() if k != "layers"},
                                   self.device), "layers": params["layers"]}
        else:
            params = _params_to(params, self.device)
        if _ffconfig.fuse_qkv:
            # before the store pins anything, so offload and resident run the
            # same launches and bits (a stack built with ``host_layers`` comes
            # fused already and is left as it is)
            params = decoder.fuse_qkv_params(spec, params, self.shard)
        if self.offload:
            params = {**params, "layers": LayerStore(params["layers"], spec.num_layers,
                                                     self.device)}
        self.params = params
        if lora is not None:
            lora = _params_to(lora, self.device)
            if self.shard is not None:
                lora = shard_lora(spec, lora, self.shard)
        self.lora = None if lora is None else route_lora(lora)
        self.lora_scale = lora_scaling(lora_config) if lora is not None and lora_config else 1.0
        self.num_adapters = 0 if lora is None else self.lora.num_adapters
        self.max_requests = max_requests_per_batch
        self.max_seq_len = max_seq_len
        self.max_tokens_per_batch = max_tokens_per_batch
        self.min_prefill_bucket = min_prefill_bucket
        self.slots = SlotBlock(max_requests_per_batch, mesh, hybrid_ffn)
        cut = None if self.shard is None else self.shard.seq
        self.cache = decoder.init_kv_cache(
            spec, self.slots.n, max_seq_len if cut is None else cut.local, cache_dtype,
            self.device, num_kv_heads=None if self.shard is None else self.shard.num_kv_cache(spec))
        # the greedy step's static buffers (this rank's slots) and, on the
        # card, its graph
        self._lens = torch.zeros(self.slots.n, dtype=torch.int32, device=self.device)
        self._tokens = torch.zeros_like(self._lens)
        # each slot's adapter for the greedy body (None: an engine without adapters)
        self._adapters = (None if lora is None else
                          torch.full_like(self._lens, -1, dtype=torch.int64))
        self.graphs = step_graphs(self.device, spec, offload=self.offload, mesh=mesh)

    # ------------------------------------------------------------------

    def _scfg(self, scfg: SamplingConfig) -> SamplingConfig:
        return SamplingConfig(
            temperature=torch.as_tensor(np.asarray(scfg.temperature, np.float32)).to(self.device),
            top_p=torch.as_tensor(np.asarray(scfg.top_p, np.float32)).to(self.device),
            top_k=torch.as_tensor(np.asarray(scfg.top_k, np.int32)).to(self.device),
        )

    @staticmethod
    def _greedy_only(scfg: SamplingConfig) -> bool:
        return bool(np.all(np.asarray(scfg.temperature) <= 0.0))

    def _sample(self, logits, key: int, scfg: SamplingConfig, rows=None):
        """``rows``: the batch rows ``logits`` (and ``scfg``) hold, whose
        indices seed the sampled rows (None: 0, 1, ...)."""
        if self._greedy_only(scfg):
            return sampling_lib.sample(logits, key, scfg, greedy_only=True)
        return sampling_lib.sample(logits, key, self._scfg(scfg), rows=rows)

    def _adapter_ids(self, adapter_ids: Optional[Sequence[int]], n: int):
        """``n`` rows' adapter ids (None: every row -1), checked against the
        adapters held, on the device; None for an engine without adapters."""
        ids = (np.full(n, -1, np.int64) if adapter_ids is None
               else np.asarray(adapter_ids, np.int64).reshape(n))
        if np.any(ids >= self.num_adapters):
            raise ValueError(f"adapter ids {ids.tolist()}: the engine holds "
                             f"{self.num_adapters} adapters")
        return None if self.lora is None else to_device(ids, self.device, np.int64)

    def _routing(self, ids: Optional[torch.Tensor]) -> dict:
        """The decoder's rank and LoRA arguments for rows routed to ``ids``
        (device; None: no adapters)."""
        kw = {} if self.shard is None else dict(shard=self.shard)
        return kw if ids is None else dict(kw, lora=self.lora, adapter_ids=ids,
                                           lora_scale=self.lora_scale)

    def fetch(self, x) -> np.ndarray:
        """Device -> host (waits for the device)."""
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def prefill_bucket(self, prompt_len: int) -> int:
        return min(_round_up_pow2(max(prompt_len, 1), self.min_prefill_bucket),
                   self.max_seq_len)

    def attn_window_bucket(self, max_len: int):
        """Power-of-two attention window covering ``max_len`` (None once it
        reaches the full cache). Decode takes no window: the decode kernel
        reads only committed positions."""
        w = _round_up_pow2(max(int(max_len), 1), 128)
        return None if w >= self.max_seq_len else w

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def prefill_batch_to_slots_async(self, prompts, slots, key: int,
                                     scfg: SamplingConfig, adapter_ids=None):
        """Admit several requests in one forward; returns the [NB] device
        tokens (first token per admission; padding rows at the end).
        ``adapter_ids``: one LoRA adapter per prompt (-1: none)."""
        real_nb = len(prompts)
        nb = 1
        while nb < real_nb:
            nb *= 2
        nb = min(nb, max(self.max_requests, real_nb))
        # the whole batch's bucket, on every data rank
        bucket = max(self.prefill_bucket(len(p)) for p in prompts)
        if self.slots.split:
            mine = self.slots.rows(slots)
            toks = None
            if mine:
                pick = lambda xs: None if xs is None else [xs[i] for i in mine]
                sc = SamplingConfig(*(np.asarray(f)[mine] for f in scfg))
                toks = self._prefill_rows(
                    pick(prompts), [slots[i] - self.slots.lo for i in mine], key, sc,
                    pick(adapter_ids), bucket, mine)[:len(mine)]
            return self.slots.combine(nb, mine, toks, self.device)
        return self._prefill_rows(prompts, slots, key, scfg, adapter_ids, bucket, None)

    def _prefill_rows(self, prompts, slots, key: int, scfg: SamplingConfig, adapter_ids,
                      bucket: int, rows):
        """``prefill_batch_to_slots_async`` over this rank's cache rows
        ``slots`` at ``bucket``; ``rows``: the prompts' global batch rows
        (their sampling seeds; None: 0, 1, ...)."""
        real_nb = len(prompts)
        nb = 1
        while nb < real_nb:
            nb *= 2
        nb = min(nb, max(self.slots.n, real_nb))
        padded = np.zeros((nb, bucket), np.int32)
        lengths = np.ones((nb,), np.int32)  # pad rows: 1 dummy token
        slots = list(slots) + [-1] * (nb - real_nb)  # -1: written nowhere
        adapters = list(adapter_ids) if adapter_ids is not None else [-1] * real_nb
        routing = self._routing(self._adapter_ids(adapters + [-1] * (nb - real_nb), nb))
        for i, p in enumerate(prompts):
            if len(p) > self.max_seq_len:
                raise ValueError(f"prompt length {len(p)} exceeds max_seq_len {self.max_seq_len}")
            padded[i, :len(p)] = p
            lengths[i] = len(p)
        if nb > real_nb:
            scfg = SamplingConfig(
                temperature=np.pad(np.asarray(scfg.temperature, np.float32), (0, nb - real_nb)),
                top_p=np.pad(np.asarray(scfg.top_p, np.float32), (0, nb - real_nb),
                             constant_values=1.0),
                top_k=np.pad(np.asarray(scfg.top_k, np.int32), (0, nb - real_nb)),
            )
        tokens = to_device(padded, self.device)
        lens_d = to_device(lengths, self.device)
        positions = torch.arange(bucket, dtype=torch.int32, device=self.device)[None].expand(nb, bucket)
        starts = np.zeros(nb, np.int64)
        first = first_position(self.shard)

        def sink(layer, k, v):  # [NB, T, KH, D] -> the admitted slots' rows (the rank's block)
            decoder.commit_kv_windows(
                self.cache.k[layer:layer + 1], self.cache.v[layer:layer + 1],
                k.permute(0, 2, 1, 3)[None].to(self.cache.k.dtype),
                v.permute(0, 2, 1, 3)[None].to(self.cache.v.dtype), starts, slots, first=first)

        with torch.no_grad():
            logits, _ = decoder.forward(
                self.spec, self.params, tokens, positions, lengths=lens_d,
                flash=True, kv_sink=sink, logits_at=lens_d - 1, **routing)
            if rows is not None:
                rows = list(rows) + [max(rows) + 1 + i for i in range(nb - real_nb)]
            return self._sample(logits, key, scfg, rows)

    def prefill_to_slot_async(self, prompt_tokens, slot: int, key: int,
                              scfg1: SamplingConfig, adapter_id: int = -1):
        """Prefill one request into ``slot``; returns its first token as a
        device scalar. Prompts over the chunked-prefill budget go in chunks."""
        n = len(prompt_tokens)
        if n > self.max_seq_len:
            raise ValueError(f"prompt length {n} exceeds max_seq_len {self.max_seq_len}")
        if self.max_tokens_per_batch and n > self.max_tokens_per_batch:
            return self._chunked_prefill_to_slot(prompt_tokens, slot, key, scfg1, adapter_id)
        return self.prefill_batch_to_slots_async(
            [prompt_tokens], [slot], key, scfg1, adapter_ids=[adapter_id])[0]

    def _chunked_prefill_to_slot(self, prompt_tokens, slot: int, key: int,
                                 scfg1: SamplingConfig, adapter_id: int = -1):
        """Token-budgeted prefill: chunks of max_tokens_per_batch against the
        slot's own cache rows (written in place)."""
        mine = self.slots.rows([slot])
        if not mine:  # another data rank's slot: its token comes in the gather
            return self.slots.combine(1, [], None, self.device)[0]
        routing = self._routing(self._adapter_ids([adapter_id], 1))
        c = self.max_tokens_per_batch
        slot -= self.slots.lo
        cache1 = decoder.KVCache(self.cache.k[:, slot:slot + 1], self.cache.v[:, slot:slot + 1])
        n = len(prompt_tokens)
        done = 0
        with torch.no_grad():
            while done < n:
                m = min(c, n - done)
                padded = np.zeros((1, c), np.int32)
                padded[0, :m] = prompt_tokens[done:done + m]
                logits, _ = decoder.forward_cached(
                    self.spec, self.params, to_device(padded, self.device), cache1,
                    to_device([done], self.device), write_start=[done],
                    logits_at=to_device([m - 1], self.device), **routing)
                done += m
            tok = self._sample(logits, key, scfg1)
            return self.slots.combine(1, mine, tok, self.device)[0]

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _tokens_in(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=torch.int32)
        return to_device(tokens, self.device)

    def decode(self, cache_lens, tokens, key: int, scfg: SamplingConfig,
               adapter_ids=None) -> np.ndarray:
        """One decode step for every slot; returns [B] host tokens."""
        return self.decode_horizon(cache_lens, tokens, key, scfg, 1, adapter_ids)[0]

    def decode_horizon(self, cache_lens, tokens, key: int, scfg: SamplingConfig,
                       n: int, adapter_ids=None) -> np.ndarray:
        """n decode steps; returns [n, B] host tokens."""
        return self.fetch(self.decode_horizon_async(
            cache_lens, tokens, key, scfg, n, adapter_ids))

    def decode_horizon_async(self, cache_lens, tokens, key: int, scfg: SamplingConfig,
                             n: int, adapter_ids=None) -> torch.Tensor:
        """Dispatch n decode steps (each feeds its tokens to the next);
        returns the [n, B] device tokens without waiting.

        Step i writes its K/V at ``cache_lens + i`` and attends the
        positions below that. Greedy horizons replay the captured step on
        the card; a horizon with a sampled slot, or of an engine that
        captures nothing (CPU, ragged MoE), runs eagerly. ``adapter_ids``
        [B]: each slot's LoRA adapter (None or -1: none)."""
        lens = np.asarray(cache_lens, np.int32)
        if self._greedy_only(scfg):
            return self.greedy_horizon_async(lens, tokens, n, replay=self.graphs is not None,
                                             adapter_ids=adapter_ids)
        sl = self.slots
        routing = self._routing(self._adapter_ids(sl.local(adapter_ids) if adapter_ids
                                                  is not None else None, sl.n))
        lens_d, toks = to_device(sl.local(lens), self.device), sl.local(self._tokens_in(tokens))
        out = torch.empty((n, sl.n), dtype=torch.int32, device=self.device)
        scfg_d = self._scfg(SamplingConfig(*(sl.local(np.asarray(f)) for f in scfg)))
        with torch.no_grad():
            for i in range(n):
                logits, _ = decoder.forward_cached(
                    self.spec, self.params, toks[:, None], self.cache, lens_d, **routing)
                toks = sampling_lib.sample(logits[:, 0], sampling_lib.fold_in(key, i), scfg_d,
                                           rows=range(sl.lo, sl.lo + sl.n))
                lens_d = lens_d + 1
                out[i] = toks
        return sl.gather(out, 1)

    def _greedy_body(self, _key=None) -> None:
        """One greedy step on the static buffers, in place: K/V written at
        the lengths (each slot through its adapter in the adapter buffer),
        the argmax tokens into the token buffer, lengths + 1."""
        logits, _ = decoder.forward_cached(
            self.spec, self.params, self._tokens[:, None], self.cache, self._lens,
            **self._routing(self._adapters))
        self._tokens.copy_(torch.argmax(logits[:, 0], dim=-1))
        self._lens.add_(1)

    def _load(self, lens: np.ndarray, tokens, adapter_ids=None) -> None:
        self._lens.copy_(to_device(self.slots.local(lens), self.device))
        self._tokens.copy_(self.slots.local(self._tokens_in(tokens)))
        ids = self._adapter_ids(None if adapter_ids is None else
                                self.slots.local(np.asarray(adapter_ids)), self.slots.n)
        if ids is not None:
            self._adapters.copy_(ids)

    def greedy_horizon_async(self, cache_lens, tokens, n: int, *, replay: bool,
                             adapter_ids=None) -> torch.Tensor:
        """n greedy steps from (``cache_lens``, ``tokens``, each slot through
        its LoRA adapter in ``adapter_ids``, None: none); returns a fresh
        [n, B] device tensor, row i copied out right after step i. With
        ``replay`` (the card's only served path) each step is a replay of
        the captured body, captured here first if it is not yet; without,
        the body runs eagerly (the CPU's path, and the yardstick the card's
        replays are held against)."""
        lens = np.asarray(cache_lens, np.int32)
        if lens.shape != (self.max_requests,):
            raise ValueError(f"cache_lens must be [{self.max_requests}], got {lens.shape}")
        if replay and self.graphs is None:
            raise ValueError("replaying a captured step needs an engine on a CUDA device "
                             "whose step has static shapes (not a ragged MoE)")
        out = torch.empty((n, self.slots.n), dtype=torch.int32, device=self.device)
        with torch.no_grad():
            if replay and not self.graphs.graphs:
                self._load(lens, tokens, adapter_ids)
                self.graphs.capture(self._greedy_body, None)
            self._load(lens, tokens, adapter_ids)
            for i in range(n):
                if replay:
                    self.graphs.replay(None)
                else:
                    self._greedy_body()
                out[i] = self._tokens
        return self.slots.gather(out, 1)
