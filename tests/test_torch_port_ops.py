"""Port ops vs the JAX package at float32: norms, rotary (incl. llama3),
activations, sampling filters and the plain attention paths. Inputs come from
numpy with a fixed seed; tolerance atol 1e-5 unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops import activations as j_act
from flexflow_tpu.ops import attention as j_attn
from flexflow_tpu.ops import norms as j_norms
from flexflow_tpu.ops import rotary as j_rot
from flexflow_tpu.ops import sampling as j_samp
from flexflow_tpu.specs import RopeScaling as JRope
from flexflow_tpu_torch.ops import activations as t_act
from flexflow_tpu_torch.ops import attention as t_attn
from flexflow_tpu_torch.ops import norms as t_norms
from flexflow_tpu_torch.ops import rotary as t_rot
from flexflow_tpu_torch.ops import sampling as t_samp
from flexflow_tpu_torch.specs import RopeScaling as TRope

torch.set_num_threads(2)
ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


def test_norms_match():
    r = _rng(1)
    x = r.standard_normal((3, 5, 64)).astype(np.float32)
    sc = r.standard_normal(64).astype(np.float32)
    bi = r.standard_normal(64).astype(np.float32)
    _close(t_norms.rms_norm(torch.tensor(x), torch.tensor(sc), 1e-6),
           j_norms.rms_norm(jnp.asarray(x), jnp.asarray(sc), 1e-6))
    _close(t_norms.layer_norm(torch.tensor(x), torch.tensor(sc), torch.tensor(bi), 1e-5),
           j_norms.layer_norm(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi), 1e-5))


@pytest.mark.parametrize("norm", ["rms_norm", "layer_norm"])
def test_norm_rows_do_not_depend_on_the_row_count(norm):
    """A row's norm is the same bits in a call of 8 rows ([8, 1, D]: a
    decode step), of 8 x 13 (a speculative verify) and of 300, wherever the
    row sits; and within 1e-5 of JAX's."""
    r = _rng(4)
    x = torch.tensor(r.standard_normal((300, 256)).astype(np.float32) * 3).to(torch.bfloat16)
    sc = torch.tensor(r.standard_normal(256).astype(np.float32)).to(torch.bfloat16)
    bi = torch.tensor(r.standard_normal(256).astype(np.float32))
    args = (sc, 1e-5) if norm == "rms_norm" else (sc, bi, 1e-5)
    fn = getattr(t_norms, norm)
    full = fn(x, *args)
    assert torch.equal(fn(x[:8, None], *args)[:, 0], full[:8])
    assert torch.equal(fn(x[40:144].reshape(8, 13, 256), *args).reshape(104, 256), full[40:144])
    perm = torch.randperm(300, generator=torch.Generator().manual_seed(0))
    assert torch.equal(fn(x[perm], *args), full[perm])
    xf = x.float().numpy()
    jargs = [jnp.asarray(a.float().numpy()) for a in args[:-1]] + [args[-1]]
    _close(fn(x.float(), *[a.float() if isinstance(a, torch.Tensor) else a for a in args]),
           getattr(j_norms, norm)(jnp.asarray(xf), *jargs))


@pytest.mark.parametrize("scaling", [
    None,
    ("linear", 2.0, 1.0, 4.0, 8192),
    ("llama3", 8.0, 1.0, 4.0, 64),
])
def test_rope_matches(scaling):
    r = _rng(2)
    js = JRope(*scaling) if scaling else None
    ts = TRope(*scaling) if scaling else None
    pos = r.integers(0, 300, (2, 7)).astype(np.int32)
    x = r.standard_normal((2, 7, 4, 32)).astype(np.float32)
    _close(t_rot.compute_inv_freq(32, 10000.0, ts), j_rot.compute_inv_freq(32, 10000.0, js),
           rtol=1e-6, atol=1e-7)
    jc, jsn = j_rot.rope_cos_sin(jnp.asarray(pos), 32, 10000.0, js)
    tc, tsn = t_rot.rope_cos_sin(torch.tensor(pos), 32, 10000.0, ts)
    _close(tc, jc, atol=2e-5)
    _close(tsn, jsn, atol=2e-5)
    _close(t_rot.apply_rope(torch.tensor(x), tc, tsn),
           j_rot.apply_rope(jnp.asarray(x), jc, jsn), atol=2e-5)


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_new", "relu", "tanh", "sigmoid"])
def test_activations_match(name):
    x = _rng(3).standard_normal((4, 33)).astype(np.float32) * 3
    _close(t_act.get_activation(name)(torch.tensor(x)),
           j_act.get_activation(name)(jnp.asarray(x)))


def test_swiglu_matches():
    r = _rng(4)
    g, u = (r.standard_normal((5, 16)).astype(np.float32) for _ in range(2))
    _close(t_act.sigmoid_silu_multi(torch.tensor(g), torch.tensor(u)),
           j_act.sigmoid_silu_multi(jnp.asarray(g), jnp.asarray(u)))


def test_filtered_logits_exact():
    r = _rng(5)
    logits = r.standard_normal((4, 50)).astype(np.float32) * 2
    temp = np.array([0.0, 0.7, 1.3, 1.0], np.float32)
    top_p = np.array([1.0, 0.9, 0.5, 0.3], np.float32)
    top_k = np.array([0, 5, 0, 12], np.int32)
    want = j_samp.filtered_logits(
        jnp.asarray(logits), j_samp.SamplingConfig(jnp.asarray(temp), jnp.asarray(top_p),
                                                   jnp.asarray(top_k)))
    got = t_samp.filtered_logits(
        torch.tensor(logits), t_samp.SamplingConfig(torch.tensor(temp), torch.tensor(top_p),
                                                    torch.tensor(top_k)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_greedy_and_distribution():
    r = _rng(6)
    logits = torch.tensor(r.standard_normal((3, 6)).astype(np.float32))
    greedy = t_samp.SamplingConfig.greedy(3)
    assert torch.equal(t_samp.sample(logits, 1, greedy), logits.argmax(-1).to(torch.int32))
    # a request's draw depends on (key, global row) only
    cfg = t_samp.SamplingConfig(torch.ones(3), torch.ones(3), torch.zeros(3, dtype=torch.int32))
    a = t_samp.sample(logits, 9, cfg)
    b = t_samp.sample(logits[1:], 9, t_samp.SamplingConfig(*(f[1:] for f in cfg)), rows=[1, 2])
    assert torch.equal(a[1:], b)
    # distribution: empirical frequencies of one row vs its softmax (5000
    # draws: 4 standard errors of a frequency <= 0.5 is < 0.03)
    row = logits[:1]
    cfg1 = t_samp.SamplingConfig(torch.ones(1), torch.ones(1), torch.zeros(1, dtype=torch.int32))
    draws = [int(t_samp.sample(row, t_samp.fold_in(3, i), cfg1)[0]) for i in range(5000)]
    freq = np.bincount(draws, minlength=6) / len(draws)
    np.testing.assert_allclose(freq, torch.softmax(row[0], -1).numpy(), atol=0.03)


def test_arg_top_k_matches():
    x = _rng(7).standard_normal((2, 20)).astype(np.float32)
    ji, jp = j_samp.arg_top_k(jnp.asarray(x), 4, return_probs=True)
    ti, tp = t_samp.arg_top_k(torch.tensor(x), 4, return_probs=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tp, jp)


def test_arg_top_k_ties_match():
    """C5: halves tie often; JAX's ids, the lower id first."""
    x = np.round(_rng(8).standard_normal((4, 40)) * 2) / 2
    ji, jp = j_samp.arg_top_k(jnp.asarray(x, jnp.float32), 6, return_probs=True)
    ti, tp = t_samp.arg_top_k(torch.tensor(x, dtype=torch.float32), 6, return_probs=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tp, jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width,k", [(8, 2), (9, 3), (64, 16), (2048, 5), (32000, 4)])
def test_top_k_helper_matches_lax_top_k(width, k, dtype):
    """The C5 helper against ``jax.lax.top_k`` on rows with many ties (values
    on a grid of halves, exact in bf16), and on all-equal rows."""
    import jax

    from flexflow_tpu_torch.ops.topk import top_k

    x = np.round(_rng(width).standard_normal((3, width)) * 2) / 2
    x[2] = 0.5
    jv, ji = jax.lax.top_k(jnp.asarray(x, getattr(jnp, dtype)), k)
    tv, ti = top_k(torch.tensor(x, dtype=torch.float32).to(getattr(torch, dtype)), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))


def _attn_inputs(seed, b=2, t=3, s=16, h=4, kh=2, d=8):
    r = _rng(seed)
    f = lambda *sh: r.standard_normal(sh).astype(np.float32)  # noqa: E731
    return dict(q=f(b, t, h, d), kc=f(b, kh, d, s), vc=f(b, kh, d, s), kn=f(b, t, kh, d),
                vn=f(b, t, kh, d), lens=np.array([5, 11], np.int32)[:b])


@pytest.mark.parametrize("variant", ["causal", "tree", "kv_mask", "alibi", "softcap"])
def test_split_cached_attention_matches(variant):
    a = _attn_inputs(8)
    b, t, h = a["q"].shape[:3]
    s = a["kc"].shape[3]
    kw_j, kw_t = {}, {}
    r = _rng(9)
    if variant == "tree":
        tm = np.tril(r.random((b, t, t)) > 0.3) | np.eye(t, dtype=bool)[None]
        kw_j["new_mask"], kw_t["new_mask"] = jnp.asarray(tm), torch.tensor(tm)
    if variant == "kv_mask":
        km = r.random((b, t, s)) > 0.4
        kw_j["kv_mask"], kw_t["kv_mask"] = jnp.asarray(km), torch.tensor(km)
    if variant == "alibi":
        kw_j["slopes"] = j_attn.alibi_slopes(h)
        kw_t["slopes"] = t_attn.alibi_slopes(h)
        _close(kw_t["slopes"], kw_j["slopes"], atol=1e-7)
    if variant == "softcap":
        kw_j["logit_softcap"] = kw_t["logit_softcap"] = 2.5
    want = j_attn.split_cached_attention(
        jnp.asarray(a["q"]), jnp.asarray(a["kc"]), jnp.asarray(a["vc"]), jnp.asarray(a["kn"]),
        jnp.asarray(a["vn"]), jnp.asarray(a["lens"]), **kw_j)
    # the port's cache is [B, KH, S, D]
    got = t_attn.split_cached_attention(
        torch.tensor(a["q"]), torch.tensor(a["kc"]).transpose(2, 3),
        torch.tensor(a["vc"]).transpose(2, 3), torch.tensor(a["kn"]), torch.tensor(a["vn"]),
        torch.tensor(a["lens"]), **kw_t)
    _close(got, want)


@pytest.mark.parametrize("variant", ["causal", "tree", "alibi"])
def test_cached_attention_matches(variant):
    r = _rng(10)
    b, t, s, h, kh, d = 2, 3, 12, 4, 1, 8
    q = r.standard_normal((b, t, h, d)).astype(np.float32)
    kc = r.standard_normal((b, s, kh, d)).astype(np.float32)
    vc = r.standard_normal((b, s, kh, d)).astype(np.float32)
    lens = np.array([2, 7], np.int32)
    kw_j, kw_t = {}, {}
    if variant == "tree":
        tm = np.tril(r.random((b, t, t)) > 0.5) | np.eye(t, dtype=bool)[None]
        kw_j["tree_mask"], kw_t["tree_mask"] = jnp.asarray(tm), torch.tensor(tm)
    if variant == "alibi":
        kw_j["slopes"], kw_t["slopes"] = j_attn.alibi_slopes(h), t_attn.alibi_slopes(h)
    want = j_attn.cached_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(lens), **kw_j)
    got = t_attn.cached_attention(torch.tensor(q), torch.tensor(kc), torch.tensor(vc),
                                  torch.tensor(lens), **kw_t)
    _close(got, want)


@pytest.mark.parametrize("alibi", [False, True])
def test_prefill_attention_matches(alibi):
    r = _rng(11)
    s, h, kh, d = 10, 4, 2, 8
    q, k, v = (r.standard_normal(sh).astype(np.float32)
               for sh in ((s, h, d), (s, kh, d), (s, kh, d)))
    kw_j = {"slopes": j_attn.alibi_slopes(h)} if alibi else {}
    kw_t = {"slopes": t_attn.alibi_slopes(h)} if alibi else {}
    want = j_attn.prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    length=7, **kw_j)
    got = t_attn.prefill_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                   length=7, **kw_t)
    _close(got, want)
