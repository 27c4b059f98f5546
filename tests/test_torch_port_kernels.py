"""The kernels' plain PyTorch versions against the JAX Pallas kernels run in
interpret mode (as tests/test_pallas_kernels.py runs them), plus the
wrappers' CPU routing. The CUDA kernels themselves are tested on a GPU by
tests/test_torch_port_cuda.py and ``python3 chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas.decode_attention import decode_attention as j_decode
from flexflow_tpu.ops.pallas.flash_prefill import flash_prefill as j_flash
from flexflow_tpu.ops.pallas.quant_matmul import quant_matmul as j_qmm
from flexflow_tpu.ops.pallas.quant_matmul import quant_matmul_indexed as j_qmm_idx
from flexflow_tpu.quant import weight_only as jw
from flexflow_tpu_torch.models import params as t_params
from flexflow_tpu_torch.ops.kernels import decode_attention as t_da
from flexflow_tpu_torch.ops.kernels import flash_prefill as t_fp
from flexflow_tpu_torch.ops.kernels import quant_matmul as t_qm

torch.set_num_threads(2)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("cshape,f,batch", [((256,), 512, (8,)), ((128,), (4, 32), (2, 3)),
                                            ((4, 32), 128, (2,))])
def test_quant_matmul_plain_matches_pallas(cshape, f, batch):
    """bf16 x: atol 2e-2 / rtol 1e-2 (both round the dequantized weight once
    to bf16 and accumulate in f32; outputs round to bf16)."""
    r = _rng(0)
    fs = f if isinstance(f, tuple) else (f,)
    w = r.standard_normal((*cshape, *fs)).astype(np.float32)
    x = r.standard_normal((*batch, *cshape)).astype(np.float32)
    jq = jw.quantize(jnp.asarray(w), 8, 64, contract_dims=len(cshape), compute_dtype=jnp.bfloat16)
    tq = t_params.params_from_numpy(jq, dtype=torch.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(j_qmm(xb, jq, interpret=True).astype(jnp.float32))
    got = t_qm.quant_matmul(torch.tensor(x).to(torch.bfloat16), tq).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)


def test_quant_matmul_f32_logits_match_pallas():
    """f32 out (the lm_head): atol 2e-2 / rtol 1e-2 in bf16 inputs."""
    r = _rng(1)
    w = r.standard_normal((256, 384)).astype(np.float32)
    x = r.standard_normal((3, 256)).astype(np.float32)
    jq = jw.quantize(jnp.asarray(w), 8, 128, compute_dtype=jnp.bfloat16)
    tq = t_params.params_from_numpy(jq, dtype=torch.bfloat16)
    want = np.asarray(j_qmm(jnp.asarray(x, jnp.bfloat16), jq, interpret=True,
                            out_dtype=jnp.float32))
    got = t_qm.quant_matmul(torch.tensor(x).to(torch.bfloat16), tq, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=1e-2)


def test_quant_matmul_indexed_plain_matches_pallas():
    """Stacked [L, D, F] carrier addressed by layer: atol 2e-2 / rtol 1e-2 in
    bf16, and each layer bitwise equal to the unstacked call."""
    r = _rng(2)
    L, d, f = 3, 256, 512
    w = r.standard_normal((L, d, f)).astype(np.float32)
    x = r.standard_normal((4, d)).astype(np.float32)
    jq = jw.quantize(jnp.asarray(w), 8, 64, batch_dims=1, compute_dtype=jnp.bfloat16)
    tq = t_params.params_from_numpy(jq, dtype=torch.bfloat16)
    xt = torch.tensor(x).to(torch.bfloat16)
    for l in range(L):
        want = np.asarray(j_qmm_idx(jnp.asarray(x, jnp.bfloat16), jq, jnp.int32(l),
                                    interpret=True).astype(jnp.float32))
        got = t_qm.quant_matmul(xt, tq, layer=l)
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=1e-2)
        unit = t_qm.qmm_int8(xt, tq.q[l], tq.scale[l], group_size=tq.group_size, n_out=f)
        assert torch.equal(got, unit)


def test_qmm_int8_plain_rows_independent_of_row_count():
    r = _rng(3)
    q = torch.tensor(r.integers(-127, 128, (128, 96)).astype(np.int8))
    s = torch.tensor(r.random((2, 96)).astype(np.float32))
    x = torch.tensor(r.standard_normal((16, 128)).astype(np.float32)).to(torch.bfloat16)
    full = t_qm.qmm_int8(x, q, s, group_size=64, n_out=90)
    for i in (0, 7, 15):
        assert torch.equal(t_qm.qmm_int8(x[i:i + 1], q, s, group_size=64, n_out=90)[0], full[i])


def test_qmm_int8_checks_shapes():
    q = torch.zeros((64, 32), dtype=torch.int8)
    s = torch.ones((1, 32))
    with pytest.raises(ValueError):
        t_qm.qmm_int8(torch.zeros((2, 48)), q, s, group_size=64, n_out=32)
    with pytest.raises(ValueError):
        t_qm.qmm_int8(torch.zeros((2, 64)), q, s, group_size=64, n_out=33)
    with pytest.raises(ValueError):
        t_qm.qmm_int8(torch.zeros((2, 64)), q, s, group_size=64, n_out=32, layer=0)


_T = t_qm.PREFILL_ROWS


@pytest.mark.parametrize("m,d,fp,bits,want", [
    (1, 4096, 22016, 8, "decode"), (16, 4096, 22016, 4, "decode"),
    (17, 4096, 22016, 8, "verify"), (128, 11008, 4096, 4, "verify"),
    (129, 4096, 22016, 8, "tiled"), (_T - 1, 4096, 22016, 4, "tiled"),
    (_T, 4096, 22016, 8, "two-pass"), (8192, 11008, 4096, 4, "two-pass"),
    (8192, 1001, 304, 8, "plain-loads-128"),  # D not a multiple of 8
    (8, 1000, 300, 8, "plain-loads-16"),  # Fp not a multiple of 16
    (8192, 1004, 304, 4, "plain-loads-128"),  # D/2 not a multiple of 8
])
def test_qmm_regime_by_rows_and_shape(m, d, fp, bits, want):
    """The kernel regime each bf16 call takes: by row count (decode up to 16,
    verify up to 128, the tiled kernel below the prefill threshold, the
    two-pass prefill from it) when rows can be loaded 16 bytes at a time."""
    assert t_qm.regime(m, d, fp, bits) == want
    assert t_qm.regime(m, d, fp, bits, x_bf16=False) == "f32-fma"
    if want in ("decode", "verify", "tiled", "two-pass"):
        assert t_qm.regime(m, d, fp, bits, aligned=False).startswith("plain-loads")


@pytest.mark.parametrize("kh", [4, 1, 8])  # GQA, MQA, MHA (h=8)
def test_decode_attention_plain_matches_pallas(kh):
    """f32, atol 2e-5 (same f32 softmax; summation order differs)."""
    r = _rng(4)
    b, s, h, d = 4, 64, 8, 32
    q = r.standard_normal((b, h, d)).astype(np.float32)
    kc = r.standard_normal((b, kh, d, s)).astype(np.float32)  # JAX [B, KH, D, S]
    vc = r.standard_normal((b, kh, d, s)).astype(np.float32)
    ks = r.standard_normal((b, kh, d)).astype(np.float32)
    vs = r.standard_normal((b, kh, d)).astype(np.float32)
    lens = np.array([5, 17, 0, 64], np.int32)
    want = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(lens),
                               interpret=True))
    got = t_da.decode_attention(torch.tensor(q), torch.tensor(kc).transpose(2, 3).contiguous(),
                                torch.tensor(vc).transpose(2, 3).contiguous(), torch.tensor(ks),
                                torch.tensor(vs), torch.tensor(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("kh", [4, 1, 8])  # GQA, MQA, MHA (h=8)
def test_flash_prefill_plain_matches_pallas(kh):
    """f32, atol 2e-5 on rows below each length; rows past it are zeros in
    the port (the JAX kernel lets them attend the valid prefix)."""
    r = _rng(5)
    b, s, h, d = 2, 256, 8, 32
    q = r.standard_normal((b, s, h, d)).astype(np.float32)
    k = r.standard_normal((b, s, kh, d)).astype(np.float32)
    v = r.standard_normal((b, s, kh, d)).astype(np.float32)
    lens = np.array([s, 100], np.int32)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens), block_q=64, block_k=128, interpret=True))
    got = t_fp.flash_prefill(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                             torch.tensor(lens)).numpy()
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=2e-5, rtol=1e-4)
        assert not got[i, n:].any()


def test_wrappers_route_cpu_tensors_to_plain_versions():
    """CPU tensors run the plain version and count no launch."""
    before = (t_qm.LAUNCHES, t_da.LAUNCHES, t_fp.LAUNCHES)
    t_qm.qmm_int8(torch.zeros((1, 64)), torch.zeros((64, 8), dtype=torch.int8),
                  torch.ones((1, 8)), group_size=64, n_out=8)
    t_da.decode_attention(torch.zeros((1, 2, 32)), torch.zeros((1, 2, 4, 32)),
                          torch.zeros((1, 2, 4, 32)), torch.zeros((1, 2, 32)),
                          torch.zeros((1, 2, 32)), torch.tensor([2], dtype=torch.int32))
    t_fp.flash_prefill(torch.zeros((1, 4, 2, 16)), torch.zeros((1, 4, 2, 16)),
                       torch.zeros((1, 4, 2, 16)), torch.tensor([3], dtype=torch.int32))
    assert (t_qm.LAUNCHES, t_da.LAUNCHES, t_fp.LAUNCHES) == before


@pytest.mark.parametrize("lens_l", [[0, 1], [1, 80]])
def test_flash_prefill_plain_short_rows_match_pallas(lens_l):
    """Rows of length 0 and 1, S = 80 (not a multiple of the kernel's 64-row
    tile), GQA: f32, atol 2e-5 on rows below each length; the rest are
    zeros and nothing is NaN."""
    r = _rng(6)
    b, s, h, kh, d = 2, 80, 4, 2, 16
    q = r.standard_normal((b, s, h, d)).astype(np.float32)
    k = r.standard_normal((b, s, kh, d)).astype(np.float32)
    v = r.standard_normal((b, s, kh, d)).astype(np.float32)
    lens = np.array(lens_l, np.int32)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens), block_q=64, block_k=128, interpret=True))
    got = t_fp.flash_prefill(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                             torch.tensor(lens)).numpy()
    assert np.isfinite(got).all()
    for i, n in enumerate(lens_l):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=2e-5, rtol=1e-4)
        assert not got[i, n:].any()


@pytest.mark.parametrize("q_shape,cache_shape,want", [
    # served INT8 / INT4 decode: 8 slots, LLaMA-2-7B heads, 1024 positions
    ((8, 32, 128), (8, 32, 1024, 128), (17, (8, 32, 17, 130))),
    # the speculative verify's tree: 8 slots x 13 nodes
    ((8, 13, 32, 128), (8, 32, 1024, 128), (17, (104, 32, 17, 130))),
    # the 160M draft's root step: 6 heads
    ((8, 6, 128), (8, 6, 1024, 128), (17, (8, 6, 17, 130))),
    # one 4096-position request; GQA at a small head dim
    ((1, 32, 128), (1, 32, 4096, 128), (65, (1, 32, 65, 130))),
    ((2, 3, 16, 64), (2, 4, 61, 64), (1, (6, 16, 1, 66))),
], ids=["decode", "tree", "draft", "long", "gqa-short"])
def test_decode_attention_plan_from_shapes(q_shape, cache_shape, want):
    """The launch plan (chunks per row, workspace shape) of the served
    shapes, from meta tensors, which hold no values: the plan reads shapes
    only, never cache_lens. Every virtual position a row can have (at most
    S committed, T - 1 ancestors and the token itself) lies in a chunk, and
    the last chunk is needed by some row."""
    q = torch.empty(q_shape, device="meta")
    cache = torch.empty(cache_shape, device="meta")
    chunks, ws_shape = t_da.plan(q, cache)
    assert (chunks, ws_shape) == want
    nt = q_shape[1] if len(q_shape) == 4 else 1
    positions = cache_shape[2] + nt
    assert (chunks - 1) * t_da.CHUNK < positions <= chunks * t_da.CHUNK
