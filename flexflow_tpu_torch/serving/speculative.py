"""Tree-based speculative decoding (SpecInfer): draft tree + token-tree
verification (port of ``flexflow_tpu/serving/speculative.py``). An engine
pairs the verifier with one draft; several drafts are several engines over
one verifier parameter tree and one verifier cache (``llm_cache=``), which
``MultiSSMSpecManager`` rotates or merges. Either model may be a MoE: both
run ``decoder.forward_cached`` with their own ``spec.moe.impl``.

- draft phase: beam-tree expansion on the small model (``build_draft_phase``).
  The root step runs the draft's cached forward on the last committed token
  (T=1: the decode-attention kernel); each depth then runs the W beam tips
  against the cache plus the tree so far, kept in a small ``[L, B, tree, KH,
  D]`` buffer (``extra_kv``), followed by BeamTopK expansion.
- verify: one cached forward of the verifier over the whole tree under its
  ancestor mask, returning the tree's K/V instead of writing the cache. On
  the card its attention is the decode-attention kernel's tree form, so each
  node gets the bits incremental decoding would give it.
- accept: the greedy walk along the verifier's argmax choices (lossless
  against incremental greedy decoding) or the stochastic walk of
  ``spec_sampling``.
- commit: the accepted columns of both buffers are written into both caches
  at ``[lens, lens + depth + 1)``.

Tree layout: slot 0 is the root (last committed token); slot
``1 + (d - 1) * W + w`` is beam w at depth d.

The JAX package chains a horizon of iterations as one XLA program with
staged KV buffers, an optimization barrier and donated caches
(``fused_step_n_fn``). Here a greedy iteration is one body over static
device buffers (lens and roots in, produced tokens and accepted counts out,
lens and roots advanced in place; ``serving/graphs.py``). On the card it is
captured at the first greedy horizon in one CUDA graph per draft attention
window (``window_buckets``), and every greedy horizon is n replays, each
replay's outputs copied out into fresh ``[n, ...]`` tensors. On the CPU the
same body runs n times uncaptured. A horizon with a sampled slot is not
captured: its iterations are issued eagerly, without a host sync
(``spec_sampling`` seeds one generator per row on the host). Nor is any
iteration of an engine whose verifier or draft is a ragged MoE (its expert
group sizes are read on the host): such an engine captures nothing. Lens,
roots and produced tokens stay device tensors until ``fetch``, each
iteration's tree K/V lives in its own buffer, and the caches are updated in
place.

Under a mesh (JAX ``mesh=``) the verifier and the draft are both cut
(``parallel/sharding``), both caches hold the rank's KV heads and its data
rank's block of slots, and every public method keeps the one-device shapes
(``engine.SlotBlock``: a data rank computes its own slots' rows, whose bits
do not depend on the rows around them, and the results are gathered over
the ``data`` axis). The tree verification runs the decode-attention
kernel's tree form on the rank's own heads.

Under a context degree (``seq > 1``) the verifier's cache is cut on its
positions (``sharding.with_seq``): the tree verification runs the tree
form's shard form and merges over ``seq``, and the prefill, the commits
(``commit_from_buffer``, ``_commit``) write the rank's block of
positions. The draft and its cache stay whole on every seq rank (JAX cuts
both caches), as the verifier's stages leave the draft whole under
pipeline parallelism, which keeps the draft's ``extra_kv`` expansion off
the seq path.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.device import resolve_device
from flexflow_tpu_torch.models import decoder
from flexflow_tpu_torch.models.decoder import KVCache, to_device
from flexflow_tpu_torch.ops import sampling as sampling_lib
from flexflow_tpu_torch.ops.sampling import SamplingConfig
from flexflow_tpu_torch.ops.topk import top_k
from flexflow_tpu_torch.parallel.mesh import SEQ_AXIS
from flexflow_tpu_torch.parallel.sharding import first_position, with_seq
from flexflow_tpu_torch.serving.engine import SlotBlock, _round_up_pow2, place_params
from flexflow_tpu_torch.serving.graphs import step_graphs
from flexflow_tpu_torch.serving.spec_sampling import tree_sample_walk
from flexflow_tpu_torch.specs import ModelSpec

# Reference caps: beam width <= 3, depth <= 8, tree <= 64 tokens.
MAX_SPEC_TREE_TOKEN_NUM = 64


def tree_size(width: int, depth: int) -> int:
    return 1 + width * depth


def make_depths_vec(width: int, depth: int, device=None) -> torch.Tensor:
    """Per-tree-slot depth [tree] int32: slot 0 = 0; 1+(d-1)*W+w = d."""
    depths = torch.zeros(tree_size(width, depth), dtype=torch.int32, device=device)
    for d in range(1, depth + 1):
        depths[1 + (d - 1) * width: 1 + d * width] = d
    return depths


def _log_softmax_topk(logits: torch.Tensor, k: int):
    logp = torch.log_softmax(logits.float(), dim=-1)
    vals, idx = top_k(logp, k)
    return vals, idx.to(torch.int32)


def draft_window(max_len: int, max_seq_len: int) -> Optional[int]:
    """The draft's cache-read window: a power of two from 128 covering
    ``max_len``, None once it reaches the full cache. ``max_len`` must bound
    every active slot's committed length when the step runs (pipelined
    callers add in-flight iterations x (depth + 1))."""
    w = _round_up_pow2(max(int(max_len), 1), 128)
    return None if w >= max_seq_len else w


def build_draft_phase(ssm_spec: ModelSpec, width: int, depth: int, shard=None):
    """The draft-tree expansion as a function ``draft_phase(ssm_params,
    ssm_cache, cache_lens, roots, window=None) -> (tree_tokens [B, T],
    tree_parents [B, T], anc_self [B, T, T], (buf_k, buf_v) [L, B, T, KH,
    D])``. The tree K/V stays in the buffers; the draft cache is not
    written. ``shard``: the draft's cut (a tensor-parallel rank's)."""
    w, dmax = width, depth
    tree = tree_size(w, dmax)

    def draft_phase(ssm_params, ssm_cache: KVCache, cache_lens, roots, window=None):
        b = cache_lens.shape[0]
        dev = cache_lens.device
        depths_vec = make_depths_vec(w, dmax, dev)
        cdt = ssm_cache.k.dtype
        logits, (k0, v0) = decoder.forward_cached(
            ssm_spec, ssm_params, roots[:, None], ssm_cache, cache_lens,
            write_cache=False, shard=shard)
        shape = (ssm_spec.num_layers, b, tree, k0.shape[3], ssm_spec.head_dim)
        buf_k = torch.zeros(shape, dtype=cdt, device=dev)
        buf_v = torch.zeros(shape, dtype=cdt, device=dev)
        buf_k[:, :, 0:1] = k0
        buf_v[:, :, 0:1] = v0
        beam_logp, beam_tokens = _log_softmax_topk(logits[:, 0], w)

        anc = torch.zeros((b, w, tree), dtype=torch.bool, device=dev)
        anc[:, :, 0] = True
        tree_tokens = torch.zeros((b, tree), dtype=torch.int32, device=dev)
        tree_tokens[:, 0] = roots
        tree_parents = torch.full((b, tree), -1, dtype=torch.int32, device=dev)
        abs_parents = torch.zeros((b, w), dtype=torch.int32, device=dev)
        eye_w = torch.eye(w, dtype=torch.bool, device=dev)[None].expand(b, w, w)
        ex_pos = cache_lens[:, None] + depths_vec[None, :]
        slots = torch.arange(tree, device=dev)

        for d in range(1, dmax + 1):
            base = 1 + (d - 1) * w
            tree_tokens[:, base:base + w] = beam_tokens
            tree_parents[:, base:base + w] = abs_parents
            positions = (cache_lens + d)[:, None].expand(b, w).to(torch.int32)
            logits, (kd, vd) = decoder.forward_cached(
                ssm_spec, ssm_params, beam_tokens, ssm_cache, cache_lens,
                positions=positions, tree_mask=eye_w, extra_kv=(buf_k, buf_v),
                extra_mask=anc, extra_positions=ex_pos, write_cache=False,
                attn_window=window, shard=shard)
            buf_k[:, :, base:base + w] = kd
            buf_v[:, :, base:base + w] = vd
            if d == dmax:
                break
            self_slots = base + torch.arange(w, device=dev)
            anc_self = anc | (slots[None, None, :] == self_slots[None, :, None])
            cand_logp, cand_tok = _log_softmax_topk(logits, w)  # [B, W, W]
            total = beam_logp[:, :, None] + cand_logp
            beam_logp, flat_idx = top_k(total.reshape(b, w * w), w)
            parents = flat_idx // w
            beam_tokens = torch.gather(cand_tok.reshape(b, w * w), 1, flat_idx)
            anc = torch.gather(anc_self, 1, parents[:, :, None].expand(b, w, tree))
            abs_parents = (base + parents).to(torch.int32)

        # ancestor matrix from the parents (parent < child)
        anc_self = torch.zeros((b, tree, tree), dtype=torch.bool, device=dev)
        anc_self[:, 0, 0] = True
        rows = torch.arange(b, device=dev)
        for c in range(1, tree):
            row = anc_self[rows, tree_parents[:, c].long().clamp(min=0)]  # a copy
            row[:, c] = True
            anc_self[:, c] = row
        return tree_tokens, tree_parents, anc_self, (buf_k, buf_v)

    return draft_phase


def commit_from_buffer(cache: KVCache, cache_lens: torch.Tensor, buf_k: torch.Tensor,
                       buf_v: torch.Tensor, path_slots: torch.Tensor,
                       first: int = 0) -> KVCache:
    """Write the accepted tree columns ``path_slots`` [B, n] of the buffers
    [L, B, T, KH, D] into the cache at [lens, lens + n), in place and without
    a host sync. Columns past S are dropped; junk beyond the accepted count
    lands past the committed length, where the next iteration overwrites it
    before anything attends it. ``first``: the cache holds a seq rank's
    block of positions from ``first`` on (the columns inside it are written)."""
    ll, b, _, kh, dh = buf_k.shape
    n = path_slots.shape[1]
    idx = path_slots.long()[None, :, :, None, None].expand(ll, b, n, kh, dh)
    slots, pos, keep = decoder.device_window(cache_lens, n, cache.max_seq_len, first)
    keep = keep[:, :, None, None, None]
    for c, buf in ((cache.k, buf_k), (cache.v, buf_v)):
        new = torch.gather(buf, 2, idx).permute(1, 2, 0, 3, 4).to(c.dtype)  # [B, n, L, KH, D]
        c[:, slots, :, pos] = torch.where(keep, new, c[:, slots, :, pos])
    return cache


def greedy_accept_walk(expected, tree_tokens, tree_parents, depth: int):
    """Greedy tree acceptance: walk the tree along the verifier's argmax
    choices ``expected`` [B, T] (lossless against incremental greedy).

    Returns (produced [B, depth+1], n_acc [B], from_slots [B, T]) int32.
    """
    b, tree = tree_tokens.shape
    dev = tree_tokens.device
    cur = torch.zeros(b, dtype=torch.long, device=dev)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    n_acc = torch.ones(b, dtype=torch.int32, device=dev)
    produced = torch.zeros((b, depth + 1), dtype=torch.int32, device=dev)
    from_slots = torch.arange(tree, dtype=torch.int32, device=dev)[None].repeat(b, 1)
    for i in range(depth + 1):
        exp = torch.gather(expected, 1, cur[:, None])[:, 0].to(torch.int32)
        produced[:, i] = exp
        if i == depth:
            break
        match = (tree_parents == cur[:, None]) & (tree_tokens == exp[:, None])
        found = match.any(dim=-1) & alive
        child = torch.argmax(match.to(torch.int32), dim=-1)  # first match
        from_slots[:, i + 1] = torch.where(found, child.to(torch.int32),
                                           torch.full_like(n_acc, i + 1))
        n_acc = n_acc + found.to(torch.int32)
        cur = torch.where(found, child, cur)
        alive = found
    return produced, n_acc, from_slots


def prefill_into(spec: ModelSpec, params, cache: KVCache, prompts, slots, bucket: int, *,
                 shard=None) -> torch.Tensor:
    """One causal forward of ``prompts`` (padded to ``bucket``) through the
    flash-prefill kernel, each layer's K/V written into ``cache``'s rows
    ``slots`` (a seq rank's block of positions under ``shard.seq``); returns
    the logits at each prompt's last position [NB, V]."""
    nb, dev = len(prompts), cache.k.device
    padded = np.zeros((nb, bucket), np.int32)
    lengths = np.zeros((nb,), np.int32)
    first = first_position(shard)
    size = cache.max_seq_len if shard is None or shard.seq is None else shard.seq.size
    for i, p in enumerate(prompts):
        if len(p) > size:
            raise ValueError(f"prompt length {len(p)} exceeds max_seq_len {size}")
        padded[i, :len(p)] = p
        lengths[i] = len(p)
    lens_d = to_device(lengths, dev)
    positions = torch.arange(bucket, dtype=torch.int32, device=dev)[None].expand(nb, bucket)
    starts = np.zeros(nb, np.int64)

    def sink(layer, k, v):  # [NB, T, KH, D] -> the admitted slots' rows
        decoder.commit_kv_windows(
            cache.k[layer:layer + 1], cache.v[layer:layer + 1],
            k.permute(0, 2, 1, 3)[None].to(cache.k.dtype),
            v.permute(0, 2, 1, 3)[None].to(cache.v.dtype), starts, slots, first=first)

    with torch.no_grad():
        return decoder.forward(spec, params, to_device(padded, dev), positions, lengths=lens_d,
                               flash=True, kv_sink=sink, logits_at=lens_d - 1, shard=shard)[0]


def sample_walk(key: int, scfg: SamplingConfig, width: int, depth: int, row_offset: int = 0):
    """A walk ``walk(logits [B, T, V], tree_tokens, tree_parents)`` that
    verifies stochastically against each row's target distribution
    (``scfg`` fields [B] on the device); row r draws from ``fold_in(key,
    row_offset + r)``."""
    def walk(logits, tree_tokens, tree_parents):
        b, t, v = logits.shape
        rep = SamplingConfig(*(torch.repeat_interleave(f, t) for f in scfg))
        p_tree = sampling_lib.target_probs(logits.reshape(b * t, v), rep).reshape(b, t, v)
        return tree_sample_walk(p_tree, tree_tokens, tree_parents, key, width=width,
                                depth=depth, row_offset=row_offset)
    return walk


class SpecEngine:
    """Draft expansion, tree verification and KV commit for one verifier and
    one draft model, with both KV caches on one device."""

    def __init__(
        self,
        llm_spec: ModelSpec,
        llm_params,
        ssm_spec: ModelSpec,
        ssm_params,
        *,
        beam_width: int = 3,
        beam_depth: int = 8,
        max_requests_per_batch: int = 8,
        max_seq_len: int = 256,
        cache_dtype=torch.bfloat16,
        device=None,
        llm_cache: Optional[KVCache] = None,
        mesh=None,
    ):
        """``llm_cache``: a verifier cache to share (another engine's, for
        several drafts against one verifier) instead of a new one. Passing
        that engine's ``llm_params`` too shares its parameter tensors: they
        are on the device, cut and fused already, so nothing is copied.
        ``mesh``: this rank's ``parallel/mesh.Mesh`` (tensor and data
        parallelism)."""
        if llm_spec.vocab_size != ssm_spec.vocab_size:
            raise ValueError("the verifier and the draft need one vocabulary")
        t = tree_size(beam_width, beam_depth)
        if t > MAX_SPEC_TREE_TOKEN_NUM:
            raise ValueError(f"tree {t} exceeds the cap {MAX_SPEC_TREE_TOKEN_NUM}")
        if mesh is not None and mesh.pipe > 1:
            raise ValueError("a mesh with pipeline stages is served by "
                             "serving/pp_spec.PipelineSpecEngine")
        self.device = resolve_device(device if mesh is None or device is not None
                                     else mesh.device)
        self.mesh = mesh
        self.llm_spec, self.ssm_spec = llm_spec, ssm_spec
        # draft and verifier fuse together (config.fuse_qkv), so decode,
        # draft expansion and tree verification stay mutually consistent
        llm_params, self.llm_shard = place_params(llm_spec, llm_params, self.device, mesh)
        ssm_params, self.ssm_shard = place_params(ssm_spec, ssm_params, self.device, mesh)
        if self.llm_shard is not None:  # the verifier's cache cut on seq; the draft's whole
            self.llm_shard = with_seq(self.llm_shard, max_seq_len)
        cut = None if self.llm_shard is None else self.llm_shard.seq
        llm_len = max_seq_len if cut is None else cut.local
        self.llm_params, self.ssm_params = llm_params, ssm_params
        self.slots = SlotBlock(max_requests_per_batch, mesh)
        nb = self.slots.n
        self.width, self.depth, self.tree = beam_width, beam_depth, t
        self.max_requests = max_requests_per_batch
        self.max_seq_len = max_seq_len
        def kv_heads(spec, sh):
            return None if sh is None else sh.num_kv_cache(spec)

        if llm_cache is None:
            llm_cache = decoder.init_kv_cache(llm_spec, nb, llm_len, cache_dtype,
                                              self.device, kv_heads(llm_spec, self.llm_shard))
        elif ((llm_cache.num_slots, llm_cache.max_seq_len) != (nb, llm_len)
              or llm_cache.k.device.type != self.device.type):
            raise ValueError(f"a shared verifier cache {tuple(llm_cache.k.shape)} on "
                             f"{llm_cache.k.device} does not fit {nb} slots "
                             f"x {llm_len} positions on {self.device}")
        self.llm_cache = llm_cache
        self.ssm_cache = decoder.init_kv_cache(ssm_spec, nb, max_seq_len, cache_dtype,
                                               self.device, kv_heads(ssm_spec, self.ssm_shard))
        self._draft_phase = build_draft_phase(ssm_spec, beam_width, beam_depth, self.ssm_shard)
        self._depths = make_depths_vec(beam_width, beam_depth, self.device)
        # the greedy iteration's static buffers and, on the card, its graphs
        b, i32 = nb, torch.int32
        self._lens = torch.zeros(b, dtype=i32, device=self.device)
        self._roots = torch.zeros(b, dtype=i32, device=self.device)
        self._produced = torch.zeros((b, beam_depth + 1), dtype=i32, device=self.device)
        self._n_acc = torch.zeros(b, dtype=i32, device=self.device)
        self.graphs = step_graphs(self.device, llm_spec, ssm_spec, mesh=mesh)

    # ------------------------------------------------------------------
    # host-facing helpers
    # ------------------------------------------------------------------

    def _h(self, x, dtype=np.int32) -> torch.Tensor:
        """Host value -> device tensor (pinned, non-blocking copy)."""
        return to_device(x, self.device, dtype)

    def fetch(self, x) -> np.ndarray:
        """Device -> host (waits for the device)."""
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def _scfg(self, scfg: SamplingConfig) -> SamplingConfig:
        return SamplingConfig(
            temperature=self._h(scfg.temperature, np.float32),
            top_p=self._h(scfg.top_p, np.float32), top_k=self._h(scfg.top_k, np.int32))

    def attn_window_bucket(self, max_len: int):
        return draft_window(max_len, self.max_seq_len)

    def window_buckets(self):
        """Every value ``attn_window_bucket`` can return: the powers of two
        from 128 below ``max_seq_len``, then None. One graph each."""
        out, w = [], 128
        while w < self.max_seq_len:
            out.append(w)
            w *= 2
        return out + [None]

    def apply_slot_overrides(self, lens_dev, roots_dev, mask, new_lens, new_roots):
        """Merge host-side admissions into the device lens/roots feedback."""
        m = self._h(mask, np.bool_)
        return (torch.where(m, self._h(new_lens), lens_dev),
                torch.where(m, self._h(new_roots), roots_dev))

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def prefill_both_batch(self, prompts, slots, key: Optional[int] = None,
                           scfg: Optional[SamplingConfig] = None):
        """Admit several requests into both caches (one causal forward of
        each model through the flash-prefill kernel, each layer's K/V written
        into the slots); returns the [NB] first tokens as host ints, greedy
        unless ``scfg`` ([NB] fields) and ``key`` are given."""
        bucket = self._bucket(prompts)
        mine = self.slots.rows(slots)
        toks = None
        if mine:
            ps, ss = [prompts[i] for i in mine], [slots[i] - self.slots.lo for i in mine]
            last = prefill_into(self.llm_spec, self.llm_params, self.llm_cache, ps, ss, bucket,
                                shard=self.llm_shard)
            prefill_into(self.ssm_spec, self.ssm_params, self.ssm_cache, ps, ss, bucket,
                         shard=self.ssm_shard)
            with torch.no_grad():
                if scfg is None:
                    toks = torch.argmax(last, dim=-1)
                else:
                    sc = SamplingConfig(*(np.asarray(f)[mine] for f in scfg))
                    toks = sampling_lib.sample(last, key, self._scfg(sc), rows=mine)
        toks = self.slots.combine(len(prompts), mine, toks, self.device)
        return [int(t) for t in self.fetch(toks)]

    def _bucket(self, prompts) -> int:
        """The whole batch's prefill bucket (every data rank takes it)."""
        return min(_round_up_pow2(max(len(p) for p in prompts), 16), self.max_seq_len)

    def prefill_ssm_only(self, prompts, slots) -> None:
        """Admit requests into the draft cache only (several drafts share
        one verifier cache: only the first engine's admission fills it)."""
        bucket = self._bucket(prompts)
        mine = self.slots.rows(slots)
        if mine:
            prefill_into(self.ssm_spec, self.ssm_params, self.ssm_cache,
                         [prompts[i] for i in mine], [slots[i] - self.slots.lo for i in mine],
                         bucket, shard=self.ssm_shard)

    def catchup(self, ssm_lens, tokens) -> None:
        """Advance the draft cache over already committed tokens: one
        causal cached forward of ``tokens`` [B, C] (zero-padded) written at
        ``ssm_lens`` [B]. A row with less lag writes junk past its valid
        region, which the next forward overwrites before anything attends
        it."""
        sl = self.slots
        with torch.no_grad():
            decoder.forward_cached(self.ssm_spec, self.ssm_params,
                                   self._h(sl.local(np.asarray(tokens))), self.ssm_cache,
                                   self._h(sl.local(np.asarray(ssm_lens))), shard=self.ssm_shard)

    # ------------------------------------------------------------------
    # stepwise path: draft tree, verify and commit as three host calls
    # ------------------------------------------------------------------

    def draft_tree(self, cache_lens, root_tokens):
        """Expand the draft tree for every slot, writing the draft's tree K/V
        into its cache at [lens, lens + tree). Returns host arrays
        (tree_tokens [B, T], tree_parents [B, T], tree_depths [T])."""
        sl = self.slots
        tt, tp, depths = self._draft_tree(sl.local(np.asarray(cache_lens, np.int32)),
                                          sl.local(np.asarray(root_tokens)))
        if sl.split:
            both = sl.gather(self._h(np.stack([tt, tp], 1)), 0)
            tt, tp = (np.ascontiguousarray(x) for x in np.moveaxis(self.fetch(both), 1, 0))
        return tt, tp, depths

    def _draft_tree(self, cache_lens, root_tokens):
        lens_np = np.asarray(cache_lens, np.int32)
        b, w, dmax, t = len(lens_np), self.width, self.depth, self.tree
        lens = self._h(lens_np)
        s = self.max_seq_len
        tree_tokens = np.zeros((b, t), np.int32)
        tree_parents = np.full((b, t), -1, np.int32)
        tree_tokens[:, 0] = root_tokens
        with torch.no_grad():
            logits, _ = decoder.forward_cached(
                self.ssm_spec, self.ssm_params, self._h(root_tokens)[:, None],
                self.ssm_cache, lens, write_start=lens_np, shard=self.ssm_shard)
            beam_logp, beam_tokens = _log_softmax_topk(logits[:, 0], w)
            anc = torch.zeros((b, w, t), dtype=torch.bool, device=self.device)
            anc[:, :, 0] = True
            kv_pos = torch.arange(s, device=self.device)[None, None, :]
            committed = kv_pos < lens[:, None, None]
            rel = kv_pos - lens[:, None, None]
            in_tree = (rel >= 0) & (rel < t)
            rel_c = rel.clamp(0, t - 1).expand(b, w, s)
            eye_w = torch.eye(w, dtype=torch.bool, device=self.device)[None].expand(b, w, w)
            for d in range(1, dmax + 1):
                base = 1 + (d - 1) * w
                tree_tokens[:, base:base + w] = self.fetch(beam_tokens)
                if d > 1:
                    tree_parents[:, base:base + w] = 1 + (d - 2) * w + self.fetch(parents)
                else:
                    tree_parents[:, base:base + w] = 0
                # the last depth runs too, so its draft K/V is in the cache
                # (stepwise commit compacts it like every other slot)
                kv_mask = committed | (torch.gather(anc, 2, rel_c) & in_tree)
                logits, _ = decoder.forward_cached(
                    self.ssm_spec, self.ssm_params, beam_tokens, self.ssm_cache, lens,
                    positions=(lens + d)[:, None].expand(b, w).to(torch.int32),
                    kv_mask=kv_mask, tree_mask=eye_w, write_start=lens_np + base,
                    shard=self.ssm_shard)
                if d == dmax:
                    break
                self_slots = base + torch.arange(w, device=self.device)
                anc_self = anc | (torch.arange(t, device=self.device)[None, None, :]
                                  == self_slots[None, :, None])
                cand_logp, cand_tok = _log_softmax_topk(logits, w)
                total = beam_logp[:, :, None] + cand_logp
                beam_logp, flat_idx = top_k(total.reshape(b, w * w), w)
                parents = flat_idx // w
                beam_tokens = torch.gather(cand_tok.reshape(b, w * w), 1, flat_idx)
                anc = torch.gather(anc_self, 1, parents[:, :, None].expand(b, w, t))
        return tree_tokens, tree_parents, self.fetch(self._depths)

    def verify(self, cache_lens, tree_tokens, tree_parents, tree_depths) -> np.ndarray:
        """Verifier over the tree (its K/V written at [lens, lens + T));
        returns the greedy argmax per tree slot [B, T] on the host."""
        sl = self.slots
        lens_np = sl.local(np.asarray(cache_lens, np.int32))
        tree_tokens, tree_parents = sl.local(tree_tokens), sl.local(tree_parents)
        b, t = tree_tokens.shape
        anc = np.zeros((b, t, t), bool)
        anc[:, np.arange(t), np.arange(t)] = True
        for s in range(1, t):
            p = tree_parents[:, s]
            ok = p >= 0
            anc[ok, s] |= anc[ok, p[ok]]
        depths = np.asarray(tree_depths)
        if depths.ndim == 1:
            depths = np.broadcast_to(depths[None, :], (b, t))
        else:
            depths = sl.local(depths)
        with torch.no_grad():
            logits, _ = decoder.forward_cached(
                self.llm_spec, self.llm_params, self._h(tree_tokens), self.llm_cache,
                self._h(lens_np), positions=self._h(lens_np[:, None] + depths),
                tree_mask=self._h(anc, np.bool_), write_start=lens_np, shard=self.llm_shard)
            return self.fetch(sl.gather(torch.argmax(logits, dim=-1), 0))

    def commit(self, cache_lens, from_slots) -> None:
        """Compact the accepted tree slots of both caches:
        ``cache[lens + i] <- cache[lens + from_slots[b, i]]`` for i < T
        (identity past the accepted count)."""
        self._commit((self.llm_cache, self.ssm_cache), cache_lens, from_slots)

    def commit_llm_only(self, cache_lens, from_slots) -> None:
        """``commit`` on the verifier cache alone (merged trees of several
        drafts: each draft cache catches up over the committed tokens)."""
        self._commit((self.llm_cache,), cache_lens, from_slots)

    def _commit(self, caches, cache_lens, from_slots) -> None:
        lens_np = self.slots.local(np.asarray(cache_lens, np.int32))
        fs = self._h(self.slots.local(np.asarray(from_slots))).long()
        b, t = fs.shape
        lens = self._h(lens_np).long()
        bidx = torch.arange(b, device=self.device)[:, None].expand(b, t)
        with torch.no_grad():
            for cache in caches:
                cut = self.llm_shard.seq if cache is self.llm_cache and self.llm_shard else None
                s = cache.max_seq_len
                lo, local, size = (cut.lo, cut.local, cut.size) if cut else (0, s, s)
                # [B, T, L, KH, D] -> [L, B, KH, T, D] update windows. Under a
                # seq cut a source column may lie on another rank: each rank
                # gives the columns it holds (zero elsewhere), summed over seq
                # (exact: one rank holds each), then writes its own
                loc = torch.clamp(lens[:, None] + fs, max=size - 1) - lo
                mine = ((loc >= 0) & (loc < local))[:, :, None, None, None]
                loc = loc.clamp(0, local - 1)
                gk, gv = (torch.where(mine, c[:, bidx, :, loc], 0).permute(2, 0, 3, 1, 4)
                          .contiguous() for c in (cache.k, cache.v))
                if cut:
                    gk, gv = (self.mesh.all_reduce(g, SEQ_AXIS) for g in (gk, gv))
                decoder.commit_kv_windows(cache.k, cache.v, gk, gv, lens_np, first=lo)

    # ------------------------------------------------------------------
    # fused path: draft, verify, accept and commit without a host sync
    # ------------------------------------------------------------------

    def _verify_reg(self, cache_lens, tree_tokens, anc_self):
        """Tree verification without cache writes: logits [B, T, V] and the
        tree's K/V [L, B, T, KH, D]. Its attention reads only the committed
        positions (the tree form of the decode-attention kernel), so it takes
        no cache-read window."""
        positions = cache_lens[:, None] + self._depths[None, :]
        return decoder.forward_cached(
            self.llm_spec, self.llm_params, tree_tokens, self.llm_cache, cache_lens,
            positions=positions.to(torch.int32), tree_mask=anc_self, write_cache=False,
            shard=self.llm_shard)

    def _fused_iteration(self, lens, roots, walk: Callable, window=None):
        """One speculative iteration on device tensors: returns (produced
        [B, depth+1], n_acc [B], lens + n_acc, next roots)."""
        tree_tokens, tree_parents, anc_self, ssm_buf = self._draft_phase(
            self.ssm_params, self.ssm_cache, lens, roots, window)
        logits, llm_buf = self._verify_reg(lens, tree_tokens, anc_self)
        produced, n_acc, from_slots = walk(logits, tree_tokens, tree_parents)
        path = from_slots[:, :self.depth + 1]
        commit_from_buffer(self.llm_cache, lens, *llm_buf, path, first_position(self.llm_shard))
        commit_from_buffer(self.ssm_cache, lens, *ssm_buf, path)
        next_roots = torch.gather(produced, 1, (n_acc - 1).long()[:, None])[:, 0]
        return produced, n_acc, lens + n_acc, next_roots

    def _greedy_walk(self, logits, tree_tokens, tree_parents):
        expected = torch.argmax(logits, dim=-1)
        return greedy_accept_walk(expected, tree_tokens, tree_parents, self.depth)

    def fused_step(self, cache_lens, root_tokens, window=None) -> Tuple[np.ndarray, np.ndarray]:
        """One speculative iteration; returns host (produced [B, depth+1],
        n_acc [B]) with both caches committed."""
        p, a = self.fused_step_n(cache_lens, root_tokens, 1, window)
        return p[0], a[0]

    def fused_step_n(self, cache_lens, root_tokens, n: int,
                     window=None) -> Tuple[np.ndarray, np.ndarray]:
        """n chained iterations; returns host (produced [n, B, depth+1],
        n_acc [n, B])."""
        p, a, _, _ = self.fused_step_n_async(self._h(cache_lens), self._h(root_tokens), n,
                                             window)
        return self.fetch(p), self.fetch(a)

    def fused_step_n_async(self, lens_dev, roots_dev, n: int, window=None):
        """n chained greedy iterations on device lens/roots, issued without a
        host sync (replays of the captured iteration on the card); returns
        device (produced [n, B, depth+1], n_acc [n, B], lens_out [B],
        roots_out [B])."""
        return self.greedy_horizon_async(lens_dev, roots_dev, n, window,
                                         replay=self.graphs is not None)

    def _greedy_body(self, window) -> None:
        """One greedy iteration on the static buffers, in place."""
        p, a, lens, roots = self._fused_iteration(self._lens, self._roots, self._greedy_walk,
                                                  window)
        self._produced.copy_(p)
        self._n_acc.copy_(a)
        self._lens.copy_(lens)
        self._roots.copy_(roots)

    def greedy_horizon_async(self, lens_dev, roots_dev, n: int, window=None, *, replay: bool):
        """n greedy iterations from device (``lens_dev``, ``roots_dev``);
        returns fresh device tensors (produced [n, B, depth+1], n_acc
        [n, B], lens_out [B], roots_out [B]), iteration i's copied out right
        after it. With ``replay`` (the card's only served path) each
        iteration replays the graph of ``window``, every window's graph
        captured here first if none is yet; without, the body runs eagerly
        (the CPU's path, and the yardstick the card's replays are held
        against)."""
        if window is not None and window >= self.max_seq_len:
            window = None
        if replay and self.graphs is None:
            raise ValueError("replaying a captured iteration needs an engine on a CUDA device")
        if replay and window not in self.window_buckets():
            raise ValueError(f"window {window} is not one of {self.window_buckets()}")
        b, sl = self.slots.n, self.slots
        produced = torch.empty((n, b, self.depth + 1), dtype=torch.int32, device=self.device)
        n_acc = torch.empty((n, b), dtype=torch.int32, device=self.device)
        with torch.no_grad():
            if replay and not self.graphs.graphs:
                for w in self.window_buckets():
                    self._load(lens_dev, roots_dev)
                    self.graphs.capture(self._greedy_body, w)
            self._load(lens_dev, roots_dev)
            for i in range(n):
                if replay:
                    self.graphs.replay(window)
                else:
                    self._greedy_body(window)
                produced[i] = self._produced
                n_acc[i] = self._n_acc
        return (sl.gather(produced, 1), sl.gather(n_acc, 1), sl.gather(self._lens.clone()),
                sl.gather(self._roots.clone()))

    def _load(self, lens_dev, roots_dev) -> None:
        if lens_dev.shape != (self.max_requests,) or roots_dev.shape != (self.max_requests,):
            raise ValueError(f"lens and roots must be [{self.max_requests}]")
        self._lens.copy_(self.slots.local(lens_dev))
        self._roots.copy_(self.slots.local(roots_dev))

    def fused_sample_step(self, cache_lens, root_tokens, key: int,
                          scfg: SamplingConfig) -> Tuple[np.ndarray, np.ndarray]:
        """One iteration with stochastic verification; greedy slots
        (temperature <= 0) walk exactly as ``fused_step``."""
        p, a = self.fused_sample_step_n(cache_lens, root_tokens, key, scfg, 1)
        return p[0], a[0]

    def fused_sample_step_n(self, cache_lens, root_tokens, key: int, scfg: SamplingConfig,
                            n: int, window=None) -> Tuple[np.ndarray, np.ndarray]:
        p, a, _, _ = self.fused_sample_step_n_async(
            self._h(cache_lens), self._h(root_tokens), key, scfg, n, window)
        return self.fetch(p), self.fetch(a)

    def fused_sample_step_n_async(self, lens_dev, roots_dev, key: int, scfg: SamplingConfig,
                                  n: int, window=None):
        """Pipelined sampling horizon (see ``fused_step_n_async``), issued
        eagerly; iteration i draws from ``fold_in(key, i)``."""
        sl = self.slots
        sc = self._scfg(SamplingConfig(*(sl.local(np.asarray(f)) for f in scfg)))
        lens, roots, produced, n_acc = sl.local(lens_dev), sl.local(roots_dev), [], []
        with torch.no_grad():
            for i in range(n):
                # this data rank's slots: their global indices seed the walk
                walk = sample_walk(sampling_lib.fold_in(key, i), sc, self.width, self.depth,
                                   row_offset=self.slots.lo)
                p, a, lens, roots = self._fused_iteration(lens, roots, walk, window)
                produced.append(p)
                n_acc.append(a)
        return (sl.gather(torch.stack(produced), 1), sl.gather(torch.stack(n_acc), 1),
                sl.gather(lens), sl.gather(roots))
