"""The port's serving horizons (``InferenceEngine.decode_horizon``,
``SpecEngine.fused_step_n``) on the CPU, where the greedy step runs
uncaptured on its static buffers: the same tokens as the JAX package's
``decode_horizon`` / ``fused_step_n`` at float32 (tiny LLaMA: 2 layers,
d 64, vocab 128, max_seq_len 64); the device-side cache write bitwise equal
to the host-indexed one; the capture order (warm-up, reload, replays)
through a stand-in for the CUDA graphs; and the launch-count helper that
carries the kernels' counts across replays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import specs as jspecs
from flexflow_tpu.models import params as jp
from flexflow_tpu.ops.sampling import SamplingConfig as JSampling
from flexflow_tpu.quant import quantize_params as j_quant_params
from flexflow_tpu.serving.engine import InferenceEngine as JEngine
from flexflow_tpu.serving.speculative import SpecEngine as JSpecEngine
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import decoder as td
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.ops.kernels import decode_attention as t_da
from flexflow_tpu_torch.ops.kernels import flash_prefill as t_fp
from flexflow_tpu_torch.ops.kernels import quant_matmul as t_qm
from flexflow_tpu_torch.ops.sampling import SamplingConfig
from flexflow_tpu_torch.serving import graphs
from flexflow_tpu_torch.serving.engine import InferenceEngine
from flexflow_tpu_torch.serving.speculative import SpecEngine

torch.set_num_threads(2)

S = 64
PROMPTS = [[5, 17, 3, 99, 42], [9, 1, 4, 70, 2, 8, 11, 13, 60, 33, 21, 7]]


def _kw(kh, **over):
    return dict(dict(arch="LlamaForCausalLM", vocab_size=128, hidden_size=64, num_layers=2,
                     num_heads=4, num_kv_heads=kh, head_dim=16, intermediate_size=128,
                     max_position_embeddings=128, norm_eps=1e-6), **over)


def _models(kw, seed, bits=None):
    jparams = jp.init_params(jspecs.ModelSpec(**kw), jax.random.PRNGKey(seed), jnp.float32)
    if bits:
        jparams = j_quant_params(jspecs.ModelSpec(**kw), jparams, bits=bits, group_size=32,
                                 compute_dtype=jnp.float32)
        tparams = tp.params_from_numpy(jparams)
    else:
        tparams = tp.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jspecs.ModelSpec(**kw), jparams, tspecs.ModelSpec(**kw), tparams


def _greedy(b):
    return (np.zeros(b, np.float32), np.ones(b, np.float32), np.zeros(b, np.int32))


def _cache_np(k):
    """A JAX [L, B, KH, D, S] cache as the port's [L, B, KH, S, D]."""
    return np.swapaxes(np.asarray(k), -1, -2)


@pytest.fixture(scope="module", params=[(4, None), (2, None), (4, 8), (2, 8)],
                ids=["mha", "gqa", "mha-int8", "gqa-int8"])
def decode_pair(request):
    kh, bits = request.param
    return _models(_kw(kh), kh, bits)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_decode_horizon_equals_jax(decode_pair, n):
    """The uncaptured greedy body through ``decode_horizon``: JAX's tokens
    exactly, and the committed cache positions [0, lens + n) of each slot
    equal to JAX's (atol 1e-5 at float32)."""
    js, jparams, ts, tparams = decode_pair
    jeng = JEngine(js, jparams, max_requests_per_batch=2, max_seq_len=S,
                   cache_dtype=jnp.float32)
    teng = InferenceEngine(ts, tparams, max_requests_per_batch=2, max_seq_len=S,
                           cache_dtype=torch.float32, device="cpu")
    scfg1 = _greedy(1)
    jfirst = [jeng.prefill_to_slot(np.asarray(p, np.int32), i, jax.random.PRNGKey(0),
                                   JSampling(*scfg1)) for i, p in enumerate(PROMPTS)]
    tfirst = [int(teng.fetch(teng.prefill_to_slot_async(np.asarray(p, np.int32), i, 0,
                                                        SamplingConfig(*scfg1))))
              for i, p in enumerate(PROMPTS)]
    assert tfirst == jfirst
    lens = np.array([len(p) for p in PROMPTS], np.int32)
    want = jeng.decode_horizon(lens, np.asarray(jfirst, np.int32), jax.random.PRNGKey(1),
                               JSampling(*_greedy(2)), n)
    got = teng.decode_horizon(lens, np.asarray(tfirst, np.int32), 1, SamplingConfig(*_greedy(2)),
                              n)
    assert got.shape == (n, 2)
    np.testing.assert_array_equal(got, np.asarray(want))
    for c_t, c_j in ((teng.cache.k, jeng.cache.k), (teng.cache.v, jeng.cache.v)):
        cj = _cache_np(c_j)
        for slot, ln in enumerate(lens):
            np.testing.assert_allclose(c_t[:, slot, :, :ln + n].numpy(),
                                       cj[:, slot, :, :ln + n], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t", [1, 3])
def test_device_cache_write_equals_host_write(t):
    """``forward_cached``'s default write (indices from the device lengths)
    gives the host-indexed write's logits and cache bitwise, with one slot
    at S - 1 and one at S (columns at or past S dropped)."""
    _, _, ts, tparams = _models(_kw(2), 3)
    rng = np.random.default_rng(4)
    shape = (ts.num_layers, 4, ts.num_kv_heads, S, ts.head_dim)
    k0, v0 = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32) for _ in range(2))
    tok = torch.tensor(rng.integers(0, 128, (4, t)), dtype=torch.int32)
    lens = np.array([7, S - 1, S, 0], np.int32)
    outs = []
    for write_start in (None, lens):
        cache = td.KVCache(k0.clone(), v0.clone())
        logits, _ = td.forward_cached(ts, tparams, tok, cache, torch.tensor(lens),
                                      write_start=write_start)
        outs.append((logits, cache))
    (l_dev, c_dev), (l_host, c_host) = outs
    assert torch.equal(l_dev, l_host)
    assert torch.equal(c_dev.k, c_host.k) and torch.equal(c_dev.v, c_host.v)
    assert not torch.equal(c_dev.k[:, 0], k0[:, 0])  # slot 0 was written
    assert torch.equal(c_dev.k[:, 2], k0[:, 2])  # slot 2's column lay past S


def test_decode_horizon_past_the_cache_end_equals_host_steps():
    """A 4-step horizon with a slot starting at S - 2: its last two columns
    are dropped on the device, as host-indexed steps drop them (bitwise)."""
    _, _, ts, tparams = _models(_kw(4), 5)
    lens = np.array([S - 2, 9], np.int32)
    rng = np.random.default_rng(6)
    shape = (ts.num_layers, 2, ts.num_kv_heads, S, ts.head_dim)
    k0, v0 = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32) for _ in range(2))
    first = np.array([3, 77], np.int32)
    eng = InferenceEngine(ts, tparams, max_requests_per_batch=2, max_seq_len=S,
                          cache_dtype=torch.float32, device="cpu")
    eng.cache.k.copy_(k0)
    eng.cache.v.copy_(v0)
    got = eng.decode_horizon(lens, first, 0, SamplingConfig(*_greedy(2)), 4)
    cache = td.KVCache(k0.clone(), v0.clone())
    toks, want = torch.tensor(first), []
    for i in range(4):
        logits, _ = td.forward_cached(ts, tparams, toks[:, None], cache,
                                      torch.tensor(lens + i), write_start=lens + i)
        toks = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        want.append(toks.numpy())
    np.testing.assert_array_equal(got, np.stack(want))
    assert torch.equal(eng.cache.k, cache.k) and torch.equal(eng.cache.v, cache.v)


SPEC_LLM = _kw(2)
SPEC_SSM = _kw(1, hidden_size=32, num_heads=2, intermediate_size=64)


@pytest.fixture(scope="module")
def spec_pair():
    jl, jlp, tl, tlp = _models(SPEC_LLM, 0)
    js, jsp, ts, tsp = _models(SPEC_SSM, 1)
    return (jl, jlp, js, jsp), (tl, tlp, ts, tsp)


@pytest.mark.parametrize("window", [None, 32], ids=["full", "window32"])
def test_fused_step_n_equals_jax(spec_pair, window):
    """Three uncaptured greedy iterations through ``fused_step_n``: JAX's
    produced tokens and accepted counts exactly."""
    (jl, jlp, js, jsp), (tl, tlp, ts, tsp) = spec_pair
    kw = dict(beam_width=2, beam_depth=3, max_requests_per_batch=2, max_seq_len=S)
    jeng = JSpecEngine(jl, jlp, js, jsp, cache_dtype=jnp.float32, **kw)
    teng = SpecEngine(tl, tlp, ts, tsp, cache_dtype=torch.float32, device="cpu", **kw)
    prompts = [np.asarray(p, np.int32) for p in PROMPTS]
    jfirst = jeng.prefill_both_batch(prompts, [0, 1])
    tfirst = teng.prefill_both_batch(prompts, [0, 1])
    assert list(tfirst) == list(jfirst)
    lens = np.array([len(p) for p in PROMPTS], np.int32)
    jp_, ja = jeng.fused_step_n(lens, np.asarray(jfirst, np.int32), 3, window=window)
    tp_, ta = teng.fused_step_n(lens, np.asarray(tfirst, np.int32), 3, window=window)
    np.testing.assert_array_equal(tp_, np.asarray(jp_))
    np.testing.assert_array_equal(ta, np.asarray(ja))
    assert tp_.shape == (3, 2, 4) and (ta >= 1).all()


class _StandIn:
    """CUDA graphs' stand-in on the CPU: capture runs the warm-up body as
    ``StepGraphs.capture`` does (and records nothing), replay runs the body.
    It holds the engines' capture order to account: warm-ups on the loaded
    buffers, a reload, then the replays."""

    def __init__(self):
        self.graphs, self.replays = {}, 0

    def capture(self, body, key):
        body(key)
        self.graphs[key] = body

    def replay(self, key):
        self.graphs[key](key)
        self.replays += 1


def test_capture_order_keeps_the_decode_horizon(decode_pair):
    """The first replayed horizon captures first (one warm-up step on the
    real inputs, which writes only where the replays write again); its
    tokens and cache equal the uncaptured body's, and so do a second
    horizon's."""
    _, _, ts, tparams = decode_pair
    lens = np.array([5, 12], np.int32)
    first = np.array([3, 77], np.int32)
    outs = []
    for replay in (False, True):
        eng = InferenceEngine(ts, tparams, max_requests_per_batch=2, max_seq_len=S,
                              cache_dtype=torch.float32, device="cpu")
        eng.graphs = _StandIn()
        a = eng.greedy_horizon_async(lens, first, 4, replay=replay)
        b = eng.greedy_horizon_async(lens + 4, a[-1], 3, replay=replay)
        outs.append((a, b, eng.cache, eng.graphs))
    (a0, b0, c0, _), (a1, b1, c1, g1) = outs
    assert torch.equal(a0, a1) and torch.equal(b0, b1)
    assert torch.equal(c0.k, c1.k) and torch.equal(c0.v, c1.v)
    assert list(g1.graphs) == [None] and g1.replays == 7


def test_capture_order_keeps_the_spec_horizon(spec_pair):
    """The first replayed spec horizon warms up and captures every window
    bucket (each warm-up from the reloaded inputs), then replays: produced
    tokens, counts, lens, roots and both caches equal the uncaptured
    iterations'."""
    _, (tl, tlp, ts, tsp) = spec_pair
    prompts = [np.asarray(p, np.int32) for p in PROMPTS]
    outs = []
    for replay in (False, True):
        eng = SpecEngine(tl, tlp, ts, tsp, beam_width=2, beam_depth=3, max_requests_per_batch=2,
                         max_seq_len=512, cache_dtype=torch.float32, device="cpu")
        eng.graphs = _StandIn()
        first = eng.prefill_both_batch(prompts, [0, 1])
        lens = eng._h([len(p) for p in prompts])
        p, a, lens2, roots2 = eng.greedy_horizon_async(lens, eng._h(first), 3, 128,
                                                        replay=replay)
        outs.append((p, a, lens2, roots2, eng.llm_cache, eng.ssm_cache, eng.graphs))
    (*r0, l0, s0, _), (*r1, l1, s1, g1) = outs
    assert all(torch.equal(x, y) for x, y in zip(r0, r1))
    for c0, c1 in ((l0, l1), (s0, s1)):
        assert torch.equal(c0.k, c1.k) and torch.equal(c0.v, c1.v)
    assert list(g1.graphs) == [128, 256, None] and g1.replays == 3


def test_replay_needs_a_cuda_engine():
    _, _, ts, tparams = _models(_kw(4), 0)
    eng = InferenceEngine(ts, tparams, max_requests_per_batch=2, max_seq_len=S,
                          cache_dtype=torch.float32, device="cpu")
    assert eng.graphs is None
    with pytest.raises(ValueError, match="CUDA"):
        eng.greedy_horizon_async([1, 2], [3, 4], 2, replay=True)
    with pytest.raises(ValueError, match="cache_lens"):
        eng.greedy_horizon_async([1, 2, 3], [3, 4, 5], 2, replay=False)


def test_counted_capture_growth_is_added_per_replay():
    """``counted`` returns how much each serving kernel's launch counter
    grew while a dummy body ran and puts the counters back; adding that
    growth once per replay counts the replays' launches."""
    saved = graphs.launch_counts()
    try:
        def body():
            t_qm.LAUNCHES += 3
            t_qm.LAUNCHES_INT4 += 0
            t_da.LAUNCHES += 2
            t_fp.LAUNCHES += 1

        before = graphs.launch_counts()
        grown = graphs.counted(body)
        assert grown == (3, 0, 2, 1)
        assert graphs.launch_counts() == before
        for _ in range(5):
            graphs.add_launches(grown)
        assert graphs.launch_counts() == tuple(b + 5 * g for b, g in zip(before, grown))

        def failing():
            t_da.LAUNCHES += 4
            raise RuntimeError("capture failed")

        with pytest.raises(RuntimeError, match="capture failed"):
            graphs.counted(failing)
        assert t_da.LAUNCHES == before[2] + 10
    finally:
        graphs.add_launches(tuple(s - c for s, c in zip(saved, graphs.launch_counts())))
