"""The speculative pieces of the port against the JAX package's at float32:
``forward_cached`` with extra K/V columns (draft expansion), the draft
phase's tree, the greedy accept walk and the K/V commit from the tree
buffers. Parameters and caches cross over through params_from_numpy /
kv_cache_from_numpy; JAX's [L, B, KH, D, S] caches are transposed to the
port's [L, B, KH, S, D] for comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import specs as jspecs
from flexflow_tpu.models import decoder as jd
from flexflow_tpu.models import params as jp
from flexflow_tpu.serving import speculative as jspec
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import decoder as td
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.serving import speculative as tspec

torch.set_num_threads(2)
ATOL = 2e-5


def _pair(**over):
    kw = {**dict(arch="LlamaForCausalLM", vocab_size=96, hidden_size=64, num_layers=2,
                 num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
                 max_position_embeddings=128, norm_eps=1e-6), **over}
    jparams = jp.init_params(jspecs.ModelSpec(**kw), jax.random.PRNGKey(3), jnp.float32)
    return (jspecs.ModelSpec(**kw), jparams, tspecs.ModelSpec(**kw),
            tp.params_from_numpy(jax.tree.map(np.asarray, jparams)))


def _caches(spec, b, s, seed):
    r = np.random.default_rng(seed)
    shape = (spec.num_layers, b, spec.num_kv_heads, spec.head_dim, s)
    k, v = (r.standard_normal(shape).astype(np.float32) for _ in range(2))
    return (jd.KVCache(jnp.asarray(k), jnp.asarray(v)), tp.kv_cache_from_numpy(k, v))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("variant", ["llama", "llama_window", "mpt_alibi"])
def test_forward_cached_extra_kv_matches(variant):
    """W=3 beam tips under an identity tree mask, attending the cache plus
    E=5 extra columns through a partial extra mask (the draft's expansion
    step); under ALiBi the extra columns carry their own positions."""
    over = dict(arch="MPTForCausalLM", norm="layernorm", pos="alibi",
                act="gelu") if variant == "mpt_alibi" else {}
    js, jparams, ts, tparams = _pair(**over)
    b, t, e, s = 2, 3, 5, 32
    r = np.random.default_rng(7)
    jc, tc = _caches(js, b, s, 8)
    lens = np.array([6, 11], np.int32)
    tok = r.integers(0, 96, (b, t)).astype(np.int32)
    pos = (lens[:, None] + 2).repeat(t, 1).astype(np.int32)  # depth-2 tips
    eshape = (js.num_layers, b, e, js.num_kv_heads, js.head_dim)
    ek, ev = (r.standard_normal(eshape).astype(np.float32) for _ in range(2))
    emask = r.random((b, t, e)) > 0.5
    emask[:, :, 0] = True  # the root is every tip's ancestor
    epos = (lens[:, None] + np.array([0, 1, 1, 1, 2])[None]).astype(np.int32)
    eye = np.broadcast_to(np.eye(t, dtype=bool), (b, t, t)).copy()
    window = 16 if variant == "llama_window" else None
    jl, (jk, jv) = jd.forward_cached(
        js, jparams, jnp.asarray(tok), jc, jnp.asarray(lens), positions=jnp.asarray(pos),
        tree_mask=jnp.asarray(eye), extra_kv=(jnp.asarray(ek), jnp.asarray(ev)),
        extra_mask=jnp.asarray(emask), extra_positions=jnp.asarray(epos), write_cache=False,
        attn_window=window)
    tl, (tk, tv) = td.forward_cached(
        ts, tparams, torch.tensor(tok), tc, torch.tensor(lens), positions=torch.tensor(pos),
        tree_mask=torch.tensor(eye), extra_kv=(torch.tensor(ek), torch.tensor(ev)),
        extra_mask=torch.tensor(emask), extra_positions=torch.tensor(epos), write_cache=False,
        attn_window=window)
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)


def test_extra_kv_keeps_t1_off_the_decode_kernel():
    """A single token with extra columns attends them (plain path): its
    logits differ from the same step without them."""
    _, _, ts, tparams = _pair()
    _, tc = _caches(ts, 1, 16, 9)
    lens = torch.tensor([4], dtype=torch.int32)
    tok = torch.tensor([[5]])
    ek = torch.randn((ts.num_layers, 1, 2, ts.num_kv_heads, ts.head_dim))
    plain, _ = td.forward_cached(ts, tparams, tok, tc, lens, write_cache=False)
    extra, _ = td.forward_cached(ts, tparams, tok, tc, lens, write_cache=False,
                                 extra_kv=(ek, ek), extra_mask=torch.ones((1, 1, 2), dtype=bool))
    assert not torch.allclose(plain, extra)


@pytest.mark.parametrize("width,depth", [(2, 3), (3, 4)])
def test_draft_phase_matches_jax(width, depth):
    """Tree tokens, parents and the ancestor matrix equal JAX's exactly; the
    tree's K/V buffers within 2e-5."""
    js, jparams, ts, tparams = _pair()
    b, s = 3, 48
    jc, tc = _caches(js, b, s, 10)
    lens = np.array([5, 0, 20], np.int32)
    roots = np.array([7, 3, 60], np.int32)
    jt, jpar, janc, (jbk, jbv) = jspec.build_draft_phase(js, width, depth)(
        jparams, jc, jnp.asarray(lens), jnp.asarray(roots))
    tt, tpar, tanc, (tbk, tbv) = tspec.build_draft_phase(ts, width, depth)(
        tparams, tc, torch.tensor(lens), torch.tensor(roots))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpar.numpy(), np.asarray(jpar))
    np.testing.assert_array_equal(tanc.numpy(), np.asarray(janc))
    _close(tbk, jbk)
    _close(tbv, jbv)
    np.testing.assert_array_equal(tspec.make_depths_vec(width, depth).numpy(),
                                  np.asarray(jspec.make_depths_vec(width, depth)))
    assert tspec.tree_size(width, depth) == jspec.tree_size(width, depth)


@pytest.mark.parametrize("head", ["zero", "two_columns"])
def test_draft_phase_ties_match_jax(head):
    """C5: a zero lm_head ties every token; with only two nonzero columns
    the rest tie at the top-3's edge. Tokens and parents equal JAX's."""
    js, jparams, ts, tparams = _pair()
    w = np.zeros((js.hidden_size, js.vocab_size), np.float32)
    if head == "two_columns":
        w[:, [5, 9]] = np.random.default_rng(11).standard_normal((js.hidden_size, 2))
    jparams = {**jparams, "lm_head": jnp.asarray(w)}
    tparams = {**tparams, "lm_head": torch.tensor(w)}
    b, s = 3, 48
    jc, tc = _caches(js, b, s, 10)
    lens = np.array([5, 0, 20], np.int32)
    roots = np.array([7, 3, 60], np.int32)
    jt, jpar, janc, _ = jspec.build_draft_phase(js, 3, 3)(
        jparams, jc, jnp.asarray(lens), jnp.asarray(roots))
    tt, tpar, tanc, _ = tspec.build_draft_phase(ts, 3, 3)(
        tparams, tc, torch.tensor(lens), torch.tensor(roots))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpar.numpy(), np.asarray(jpar))
    np.testing.assert_array_equal(tanc.numpy(), np.asarray(janc))


def test_greedy_accept_walk_matches_jax():
    r = np.random.default_rng(11)
    w, d, b = 3, 4, 16
    t = 1 + w * d
    parents = np.full((b, t), -1, np.int32)
    parents[:, 1:1 + w] = 0
    for dd in range(2, d + 1):
        base, prev = 1 + (dd - 1) * w, 1 + (dd - 2) * w
        parents[:, base:base + w] = prev + r.integers(0, w, (b, w))
    tokens = r.integers(0, 6, (b, t)).astype(np.int32)  # small vocab: many matches
    expected = r.integers(0, 6, (b, t)).astype(np.int32)
    want = jspec.greedy_accept_walk(jnp.asarray(expected), jnp.asarray(tokens),
                                    jnp.asarray(parents), d)
    got = tspec.greedy_accept_walk(torch.tensor(expected), torch.tensor(tokens),
                                   torch.tensor(parents), d)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert len(set(got[1].tolist())) > 1  # several acceptance lengths exercised


def test_commit_from_buffer_matches_jax():
    """Accepted columns land at [lens, lens + n) in both layouts; a window
    running past S keeps only its in-range columns."""
    r = np.random.default_rng(12)
    L, B, KH, D, S, T, n = 2, 3, 2, 4, 12, 7, 4
    ck = r.standard_normal((L, B, KH, D, S)).astype(np.float32)
    cv = r.standard_normal((L, B, KH, D, S)).astype(np.float32)
    bk = r.standard_normal((L, B, T, KH, D)).astype(np.float32)
    bv = r.standard_normal((L, B, T, KH, D)).astype(np.float32)
    lens = np.array([3, 10, 0], np.int32)  # row 1 runs past S
    path = r.integers(0, T, (B, n)).astype(np.int32)
    want = jspec.commit_from_buffer(jd.KVCache(jnp.asarray(ck), jnp.asarray(cv)),
                                    jnp.asarray(lens), jnp.asarray(bk), jnp.asarray(bv),
                                    jnp.asarray(path))
    tc = tp.kv_cache_from_numpy(ck, cv)
    out = tspec.commit_from_buffer(tc, torch.tensor(lens), torch.tensor(bk), torch.tensor(bv),
                                   torch.tensor(path))
    assert out is tc  # in place
    wc = tp.kv_cache_from_numpy(np.asarray(want.k), np.asarray(want.v))
    assert torch.equal(tc.k, wc.k) and torch.equal(tc.v, wc.v)
