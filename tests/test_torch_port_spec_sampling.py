"""Stochastic speculative verification in the port
(``serving/spec_sampling.tree_sample_walk`` and the engine's sampling path).
The random bits differ from ``jax.random``'s, so parity with the JAX package
is the distribution (the Monte Carlo tests of tests/test_spec_sampling.py),
the exact target probabilities, and the greedy degeneration."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops import sampling as j_sampling
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.ops import sampling as t_sampling
from flexflow_tpu_torch.ops.sampling import SamplingConfig
from flexflow_tpu_torch.serving.engine import InferenceEngine
from flexflow_tpu_torch.serving.request_manager import GenerationConfig, RequestManager
from flexflow_tpu_torch.serving.spec_manager import SpecRequestManager
from flexflow_tpu_torch.serving.spec_sampling import tree_sample_walk
from flexflow_tpu_torch.serving.speculative import SpecEngine, greedy_accept_walk
from flexflow_tpu_torch.specs import ModelSpec

torch.set_num_threads(2)

TINY = ModelSpec(arch="LlamaForCausalLM", vocab_size=96, hidden_size=64, num_layers=2,
                 num_heads=4, num_kv_heads=4, head_dim=16, intermediate_size=128,
                 max_position_embeddings=256, norm_eps=1e-6)
# chain-ish tree of width 2, depth 2: slots 1, 2 children of the root; 3, 4 of slot 1
TOKENS = torch.tensor([[3, 1, 5, 2, 6]], dtype=torch.int32)
PARENTS = torch.tensor([[-1, 0, 0, 1, 1]], dtype=torch.int32)


def _dirichlet(seed, shape, conc=0.5):
    g = np.random.default_rng(seed).gamma(conc, size=shape)
    return torch.tensor(g / g.sum(-1, keepdims=True), dtype=torch.float32)


def _walk_rows(p, n, key):
    """n independent walks over the same tree: one row each."""
    return tree_sample_walk(p.expand(n, -1, -1).contiguous(), TOKENS.expand(n, -1),
                            PARENTS.expand(n, -1), key, width=2, depth=2)


def test_walk_first_token_distribution():
    """The first emitted token is distributed per the root's target, for a
    fixed deterministic draft tree: 40k draws, 4 sigma (atol 0.011)."""
    p = _dirichlet(0, (1, 5, 8))
    produced, _, _ = _walk_rows(p, 40_000, key=1)
    emp = np.bincount(produced[:, 0].numpy(), minlength=8) / 40_000
    np.testing.assert_allclose(emp, p[0, 0].numpy(), atol=0.011)


def test_walk_second_token_distribution_given_accept():
    """Given that child slot 1 was accepted, the second emitted token is
    distributed per the target at slot 1 (atol 0.02)."""
    p = _dirichlet(7, (1, 5, 8))
    produced, _, from_slots = _walk_rows(p, 60_000, key=2)
    took1 = (from_slots[:, 1] == 1) & (produced[:, 0] == 1)
    assert int(took1.sum()) > 3000
    second = produced[took1, 1].numpy()
    emp = np.bincount(second, minlength=8) / int(took1.sum())
    np.testing.assert_allclose(emp, p[0, 1].numpy(), atol=0.02)


def test_onehot_target_degenerates_to_greedy_walk():
    """One-hot targets accept exactly the matching children and emit the
    argmax: the greedy walk's (produced, n_acc, from_slots)."""
    argmaxes = torch.tensor([[4, 9, 0, 2, 0]])
    p = torch.nn.functional.one_hot(argmaxes, 16).float()
    tokens = torch.tensor([[7, 4, 5, 9, 6]], dtype=torch.int32)
    produced, n_acc, from_slots = tree_sample_walk(p, tokens, PARENTS, 11, width=2, depth=2)
    assert int(n_acc[0]) == 3
    assert produced[0].tolist() == [4, 9, 2]
    assert from_slots[0, :3].tolist() == [0, 1, 3]
    g_prod, g_acc, g_from = greedy_accept_walk(argmaxes, tokens, PARENTS, 2)
    assert torch.equal(produced, g_prod) and torch.equal(n_acc, g_acc)
    assert torch.equal(from_slots, g_from)


def test_target_probs_match_jax():
    """Filtered, renormalised targets (temperature, top-p, top-k) equal JAX's
    within 1e-6; greedy rows are one-hot at the argmax."""
    r = np.random.default_rng(3)
    logits = (r.standard_normal((4, 50)) * 3).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.3, 1.0], np.float32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5], np.float32)
    top_k = np.array([0, 0, 5, 10], np.int32)
    want = j_sampling.target_probs(jnp.asarray(logits), j_sampling.SamplingConfig(
        jnp.asarray(temp), jnp.asarray(top_p), jnp.asarray(top_k)))
    got = t_sampling.target_probs(torch.tensor(logits), SamplingConfig(
        torch.tensor(temp), torch.tensor(top_p), torch.tensor(top_k)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert got[0].tolist() == np.eye(50)[logits[0].argmax()].tolist()


def _engine():
    params = tp.init_params(TINY, 0)
    return SpecEngine(TINY, params, TINY, params, beam_width=2, beam_depth=3,
                      max_requests_per_batch=2, max_seq_len=128, cache_dtype=torch.float32,
                      device="cpu")


def test_engine_sample_step_greedy_matches_fused_step():
    """temperature 0 through the sampling walk equals the greedy walk,
    K/V commits included (the following steps stay equal)."""
    eng_a, eng_b = _engine(), _engine()
    prompt = np.asarray([5, 9, 3, 17], np.int32)
    [fa] = eng_a.prefill_both_batch([prompt], [0])
    [fb] = eng_b.prefill_both_batch([prompt], [0])
    assert fa == fb
    lens = np.asarray([len(prompt), 0], np.int32)
    roots = np.asarray([fa, 0], np.int32)
    scfg = SamplingConfig(np.zeros(2, np.float32), np.ones(2, np.float32), np.zeros(2, np.int32))
    for i in range(3):
        pa, na = eng_a.fused_step(lens, roots)
        pb, nb = eng_b.fused_sample_step(lens, roots, 42 + i, scfg)
        np.testing.assert_array_equal(na, nb)
        np.testing.assert_array_equal(pa[0, :na[0]], pb[0, :nb[0]])
        lens = lens + na
        roots = np.asarray([pa[0, na[0] - 1], 0], np.int32)
    assert torch.equal(eng_a.llm_cache.k, eng_b.llm_cache.k)


def test_manager_sampling_requests_complete():
    rm = SpecRequestManager(_engine(), fused=True, seed=1)
    reqs = rm.generate([[3, 17, 91, 5], [2, 4, 8]],
                       GenerationConfig(max_new_tokens=12, temperature=0.8, top_p=0.95))
    for r in reqs:
        assert 1 <= len(r.output_tokens) <= 12
        assert all(0 <= t < TINY.vocab_size for t in r.output_tokens)


def test_greedy_slot_in_a_sampling_horizon_stays_lossless():
    """Pipelined horizon 2 with one sampling and one greedy request: the
    greedy request equals incremental greedy decoding."""
    eng = _engine()
    greedy_prompt = [3, 17, 91, 5]
    incr = RequestManager(InferenceEngine(TINY, eng.llm_params, max_requests_per_batch=2,
                                          max_seq_len=128, cache_dtype=torch.float32,
                                          device="cpu"))
    try:
        want = incr.generate([greedy_prompt], GenerationConfig(max_new_tokens=10))[0].output_tokens
    finally:
        incr.close()
    rm = SpecRequestManager(eng, fused=True, spec_horizon=2, pipelined=True, seed=5)
    g_greedy = rm.register_request(greedy_prompt, GenerationConfig(max_new_tokens=10))
    g_samp = rm.register_request([2, 4, 8], GenerationConfig(max_new_tokens=10, temperature=0.9,
                                                              top_p=0.9))
    rm.run_until_idle()
    assert rm.get_request(g_greedy).output_tokens == want
    samp = rm.get_request(g_samp).output_tokens
    assert 1 <= len(samp) <= 10 and all(0 <= t < TINY.vocab_size for t in samp)


def test_stepwise_manager_refuses_sampled_requests():
    """The stepwise path (``fused=False``) has no stochastic verification:
    a sampled request raises where the JAX package walks it greedily; its
    greedy requests are served."""
    rm = SpecRequestManager(_engine(), fused=False, seed=1)
    [r] = rm.generate([[3, 17, 91, 5]], GenerationConfig(max_new_tokens=4))
    assert len(r.output_tokens) == 4
    with pytest.raises(NotImplementedError, match="fused=True"):
        rm.generate([[2, 4, 8]], GenerationConfig(max_new_tokens=4, temperature=0.8))
