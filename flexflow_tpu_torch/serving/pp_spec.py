"""PipelineSpecEngine — tree-speculative serving with the verifier staged over
the ``pipe`` stages of a ``parallel/mesh.Mesh`` and the draft whole on every
rank (port of ``flexflow_tpu/serving/pp_spec.py``).

The reference's flagship configuration runs spec_infer under pipeline
parallelism: the verifier's layers are binned into stages while the small
draft is replicated. JAX stage-stacks the verifier and runs one fused
iteration as one program: the draft's tree expansion replicated, the tree
verification through a ``shard_map`` scan of M + P - 1 ticks that stages each
stage's tree K/V in a buffer, the accept walk, and a per-stage commit of the
accepted columns. The port runs one process per rank (SPMD) and gives the
one-device ``SpecEngine``'s results:

- the verifier is a :class:`PipelineInferenceEngine` (this rank's stage's
  layers and its ``[L/P, B, KH, S, D]`` cache), built here or shared
  (``shared_pp``: several drafts rotate over one staged verifier);
  ``llm_cache`` is its cache;
- the draft and its cache are whole on every rank (not cut on ``model``
  under P x T), placed as ``SpecEngine`` places them; every rank expands the
  same tree (``speculative.build_draft_phase``) from the same inputs;
- the tree pass runs microbatch by microbatch through the stages
  (``PipelineInferenceEngine._stage``): stage 0 embeds the tree tokens at
  ``lens + depths``, every stage runs its layers under the ancestor mask
  without writing its cache (``forward_cached(write_cache=False)``: the tree
  form of the decode-attention kernel on the card) and keeps its tree K/V
  ``[L/P, Bm, T, KH, D]``, and the last stage unembeds;
- the last stage walks the tree (the greedy walk, or the stochastic walk
  seeded by each row's global slot, as on one device) and broadcasts
  ``produced``, ``n_acc`` and the accepted path as one int32 tensor over
  the ``pipe`` group (``Mesh.broadcast_from_stage``), so every rank returns
  the same host values and the request manager runs identically on every
  rank;
- every rank commits its stage's accepted columns into its cache rows,
  microbatch by microbatch (``commit_from_buffer``), and the draft's into
  the draft cache. JAX's staging buffer is a TPU choice the port does not
  carry over.

A horizon is n iterations in a row; sampled iteration i draws from
``fold_in(key, i)``, as ``SpecEngine`` does. The draft reads the cache
window ``SpecEngine`` would read (``attn_window_bucket``; JAX's pipeline
engine reads the whole cache), so its trees are the one-device engine's bit
for bit, and with them the accepted paths. Nothing is captured (``graphs``
is None): under gloo no collective can be. The unfused host-loop surface (``draft_tree``,
``verify``, ``commit``) raises, as JAX's does: ``LLM.compile`` pairs this
engine with ``SpecRequestManager(fused=True)``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from flexflow_tpu_torch.models import decoder
from flexflow_tpu_torch.models.decoder import to_device
from flexflow_tpu_torch.ops import sampling as sampling_lib
from flexflow_tpu_torch.ops.sampling import SamplingConfig
from flexflow_tpu_torch.serving.engine import place_params
from flexflow_tpu_torch.serving.pp_engine import PipelineInferenceEngine
from flexflow_tpu_torch.serving.speculative import (MAX_SPEC_TREE_TOKEN_NUM, build_draft_phase,
                                                    commit_from_buffer, draft_window,
                                                    greedy_accept_walk, make_depths_vec,
                                                    prefill_into, sample_walk, tree_size)
from flexflow_tpu_torch.specs import ModelSpec

UNFUSED = ("the unfused speculative loop is not served under pipeline stages; use "
           "SpecRequestManager(fused=True)")


class PipelineSpecEngine:
    """The fused surface of ``SpecEngine`` with the verifier over the
    pipeline stages of ``mesh`` (this rank's stage) and the draft whole;
    every rank of the mesh is driven with the same calls and host values."""

    graphs = None  # no CUDA graph: every iteration runs eagerly

    def __init__(
        self,
        llm_spec: ModelSpec,
        llm_params,
        ssm_spec: ModelSpec,
        ssm_params,
        *,
        mesh,  # parallel/mesh.Mesh with the pipe axis (data must be 1)
        beam_width: int = 3,
        beam_depth: int = 8,
        max_requests_per_batch: int = 8,
        max_seq_len: int = 256,
        cache_dtype=torch.bfloat16,
        num_microbatches: Optional[int] = None,  # default: the stage count
        shared_pp: Optional[PipelineInferenceEngine] = None,  # another engine's ``_pp``
        device=None,
    ):
        if llm_spec.vocab_size != ssm_spec.vocab_size:
            raise ValueError("the verifier and the draft need one vocabulary")
        t = tree_size(beam_width, beam_depth)
        if t > MAX_SPEC_TREE_TOKEN_NUM:
            raise ValueError(f"tree {t} exceeds the cap {MAX_SPEC_TREE_TOKEN_NUM}")
        if shared_pp is None:
            shared_pp = PipelineInferenceEngine(
                llm_spec, llm_params, mesh=mesh, max_requests_per_batch=max_requests_per_batch,
                max_seq_len=max_seq_len, cache_dtype=cache_dtype,
                num_microbatches=num_microbatches, device=device)
        elif (shared_pp.max_requests, shared_pp.max_seq_len) != (max_requests_per_batch,
                                                                 max_seq_len):
            raise ValueError(f"a shared staged verifier of {shared_pp.max_requests} slots x "
                             f"{shared_pp.max_seq_len} positions does not fit "
                             f"{max_requests_per_batch} x {max_seq_len}")
        self._pp = shared_pp
        self.mesh, self.device = mesh, shared_pp.device
        self.pp, self.tp = shared_pp.pp, shared_pp.tp
        self.num_microbatches = shared_pp.num_microbatches
        self.llm_spec, self.ssm_spec = llm_spec, ssm_spec
        self.llm_params = shared_pp.params
        self.width, self.depth, self.tree = beam_width, beam_depth, t
        self.max_requests, self.max_seq_len = max_requests_per_batch, max_seq_len
        # the draft whole on every rank, fused as SpecEngine fuses it
        self.ssm_params, _ = place_params(ssm_spec, ssm_params, self.device, None)
        self.ssm_cache = decoder.init_kv_cache(ssm_spec, max_requests_per_batch, max_seq_len,
                                               cache_dtype, self.device)
        self._draft_phase = build_draft_phase(ssm_spec, beam_width, beam_depth)
        self._depths = make_depths_vec(beam_width, beam_depth, self.device)

    @property
    def llm_cache(self):
        """The staged verifier's cache (shared by every engine over it)."""
        return self._pp.cache

    # ------------------------------------------------------------------
    # host-facing helpers
    # ------------------------------------------------------------------

    def _h(self, x, dtype=np.int32) -> torch.Tensor:
        return to_device(x, self.device, dtype)

    def fetch(self, x) -> np.ndarray:
        """Device -> host (waits for the device)."""
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def attn_window_bucket(self, max_len: int):
        """The draft's cache-read window, the one ``SpecEngine`` gives (JAX's
        pipeline engine reads the whole cache): the draft's bits, and so its
        trees, stay the one-device engine's."""
        return draft_window(max_len, self.max_seq_len)

    def apply_slot_overrides(self, lens_dev, roots_dev, mask, new_lens, new_roots):
        """Merge host-side admissions into the device lens/roots feedback."""
        m = self._h(mask, np.bool_)
        return (torch.where(m, self._h(new_lens), lens_dev),
                torch.where(m, self._h(new_roots), roots_dev))

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _bucket(self, prompts) -> int:
        return max(self._pp.prefill_bucket(len(p)) for p in prompts)

    def prefill_both_batch(self, prompts, slots, key: Optional[int] = None,
                           scfg: Optional[SamplingConfig] = None):
        """Admit requests into both caches: the verifier through the staged
        prefill (which samples the first tokens on the last stage and
        broadcasts them), the draft by one causal prefill on every rank;
        returns the [NB] first tokens as host ints, greedy unless ``scfg``
        ([NB] fields) and ``key`` are given."""
        if scfg is None:
            nb = len(prompts)
            scfg = SamplingConfig(np.zeros(nb, np.float32), np.ones(nb, np.float32),
                                  np.zeros(nb, np.int32))
            key = 0
        toks = self._pp.prefill_batch_to_slots_async(prompts, slots, key, scfg)
        self.prefill_ssm_only(prompts, slots)
        return [int(t) for t in self.fetch(toks)]

    def prefill_ssm_only(self, prompts, slots) -> None:
        """Admit requests into the draft cache only (several drafts share
        one staged verifier: only the first engine's admission fills it)."""
        prefill_into(self.ssm_spec, self.ssm_params, self.ssm_cache, prompts, slots,
                     self._bucket(prompts))

    def catchup(self, ssm_lens, tokens) -> None:
        """Advance the draft cache over already committed tokens (see
        ``SpecEngine.catchup``)."""
        with torch.no_grad():
            decoder.forward_cached(self.ssm_spec, self.ssm_params, self._h(tokens),
                                   self.ssm_cache, self._h(ssm_lens))

    # ------------------------------------------------------------------
    # one fused iteration
    # ------------------------------------------------------------------

    def _verify(self, lens, tree_tokens, anc_self):
        """The verifier's tree pass through the stages, microbatch by
        microbatch, writing no cache: the logits [B, T, V] on the last stage
        (None elsewhere) and this stage's tree K/V of each microbatch."""
        pp = self._pp
        positions = (lens[:, None] + self._depths[None, :]).to(torch.int32)
        logits, kv = [], []
        for j, r in enumerate(pp._rows):
            def run(h, j=j, r=r):
                out, new_kv = decoder.forward_cached(
                    self.llm_spec, pp.params, tree_tokens[r] if h is None else None,
                    pp._mb_cache[j], lens[r], positions=positions[r], tree_mask=anc_self[r],
                    write_cache=False, shard=pp.shard, hidden=h, head=pp.last)
                kv.append(new_kv)
                return out

            out = pp._stage(run, (r.stop - r.start, self.tree, self.llm_spec.hidden_size))
            if pp.last:
                logits.append(out)
        return (torch.cat(logits) if pp.last else None), kv

    def _iteration(self, lens, roots, walk: Callable, window=None):
        """Draft, staged verify, walk (last stage), broadcast and commit;
        returns device (produced [B, depth+1], n_acc [B], lens + n_acc, next
        roots), the same on every rank."""
        d1 = self.depth + 1
        tree_tokens, tree_parents, anc_self, ssm_buf = self._draft_phase(
            self.ssm_params, self.ssm_cache, lens, roots, window)
        logits, llm_kv = self._verify(lens, tree_tokens, anc_self)
        packed = torch.empty((self.max_requests, 2 * d1 + 1), dtype=torch.int32,
                             device=self.device)
        if self._pp.last:
            produced, n_acc, from_slots = walk(logits, tree_tokens, tree_parents)
            torch.cat([produced, n_acc[:, None], from_slots[:, :d1]], dim=1, out=packed)
        self._pp._finish(packed)
        produced, n_acc, path = packed[:, :d1], packed[:, d1], packed[:, d1 + 1:]
        for kv, r, cache in zip(llm_kv, self._pp._rows, self._pp._mb_cache):
            commit_from_buffer(cache, lens[r], *kv, path[r])
        commit_from_buffer(self.ssm_cache, lens, *ssm_buf, path)
        next_roots = torch.gather(produced, 1, (n_acc - 1).long()[:, None])[:, 0]
        return produced, n_acc, lens + n_acc, next_roots

    def _greedy_walk(self, logits, tree_tokens, tree_parents):
        return greedy_accept_walk(torch.argmax(logits, dim=-1), tree_tokens, tree_parents,
                                  self.depth)

    def _horizon(self, lens, roots, n: int, walk_at: Callable, window=None):
        """n iterations, iteration i walking with ``walk_at(i)``; returns
        device (produced [n, B, depth+1], n_acc [n, B], lens_out, roots_out)."""
        if lens.shape != (self.max_requests,) or roots.shape != (self.max_requests,):
            raise ValueError(f"lens and roots must be [{self.max_requests}]")
        produced, n_acc = [], []
        with torch.no_grad():
            for i in range(n):
                p, a, lens, roots = self._iteration(lens, roots, walk_at(i), window)
                produced.append(p)
                n_acc.append(a)
        return torch.stack(produced), torch.stack(n_acc), lens, roots

    # ------------------------------------------------------------------
    # the fused surface (SpecRequestManager(fused=True))
    # ------------------------------------------------------------------

    def fused_step_n(self, cache_lens, root_tokens, n: int, window=None):
        p, a, _, _ = self.fused_step_n_async(self._h(cache_lens), self._h(root_tokens), n,
                                             window)
        return self.fetch(p), self.fetch(a)

    def fused_step_n_async(self, lens_dev, roots_dev, n: int, window=None):
        """n chained greedy iterations on device lens/roots."""
        return self._horizon(lens_dev, roots_dev, n, lambda i: self._greedy_walk, window)

    def fused_sample_step_n(self, cache_lens, root_tokens, key: int, scfg: SamplingConfig,
                            n: int, window=None):
        p, a, _, _ = self.fused_sample_step_n_async(
            self._h(cache_lens), self._h(root_tokens), key, scfg, n, window)
        return self.fetch(p), self.fetch(a)

    def fused_sample_step_n_async(self, lens_dev, roots_dev, key: int, scfg: SamplingConfig,
                                  n: int, window=None):
        """n iterations with stochastic verification; iteration i draws from
        ``fold_in(key, i)``, row r from ``fold_in(that, r)``."""
        sc = SamplingConfig(self._h(scfg.temperature, np.float32),
                            self._h(scfg.top_p, np.float32), self._h(scfg.top_k, np.int32))
        return self._horizon(
            lens_dev, roots_dev, n,
            lambda i: sample_walk(sampling_lib.fold_in(key, i), sc, self.width, self.depth),
            window)

    # the unfused host-loop surface: not served under pipeline stages
    def draft_tree(self, *args, **kwargs):
        raise NotImplementedError(UNFUSED)

    verify = commit = commit_llm_only = draft_tree
