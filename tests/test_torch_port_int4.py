"""The INT4 quant-matmul's plain PyTorch version (``qmm_int4_plain``, what
``qmm_int4`` runs for CPU tensors) against the JAX Pallas INT4 kernel in
interpret mode, unstacked (``quant_matmul``) and layer-indexed
(``quant_matmul_indexed``); plus row invariance and the wrapper's checks.
The CUDA kernel itself is tested on a GPU by tests/test_torch_port_cuda.py
and ``python3 chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas.quant_matmul import quant_matmul as j_qmm
from flexflow_tpu.ops.pallas.quant_matmul import quant_matmul_indexed as j_qmm_idx
from flexflow_tpu.quant import weight_only as jw
from flexflow_tpu_torch.models import params as t_params
from flexflow_tpu_torch.ops.kernels import quant_matmul as t_qm
from flexflow_tpu_torch.quant.weight_only import dequantize, quantize

torch.set_num_threads(2)


def _carrier(w, group, cdims=1, batch_dims=0, dtype=jnp.bfloat16):
    jq = jw.quantize(jnp.asarray(w), 4, group, batch_dims=batch_dims, contract_dims=cdims,
                     compute_dtype=dtype)
    return jq, t_params.params_from_numpy(
        jq, dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("cshape,f,group,batch", [
    ((256,), 512, 64, (8,)),  # a projection
    ((4, 64), 128, 64, (2, 3)),  # the wo layout (contract_dims=2)
    ((200,), 96, 25, (5,)),  # an odd group size
])
def test_qmm_int4_plain_matches_pallas(cshape, f, group, batch):
    """bf16 x: atol 2e-2 / rtol 1e-2, as tests/test_pallas_kernels.py (both
    round the dequantized weight once to bf16 and accumulate in f32; the
    outputs round to bf16)."""
    r = np.random.default_rng(10)
    w = r.standard_normal((*cshape, f)).astype(np.float32)
    x = r.standard_normal((*batch, *cshape)).astype(np.float32)
    jq, tq = _carrier(w, group, cdims=len(cshape))
    assert tq.bits == 4 and tq.group_size == group and tq.q.dtype == torch.uint8
    want = np.asarray(j_qmm(jnp.asarray(x, jnp.bfloat16), jq, interpret=True)
                      .astype(jnp.float32))
    before = t_qm.LAUNCHES_INT4
    got = t_qm.quant_matmul(torch.tensor(x).to(torch.bfloat16), tq)
    assert t_qm.LAUNCHES_INT4 == before  # CPU tensors run the plain version
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=1e-2)


def test_qmm_int4_f32_logits_and_f32_x_match_pallas():
    """f32 logits out of bf16 x (the lm_head): atol 2e-2 / rtol 1e-2; f32 x
    and weights (the full-precision path): 1e-5 relative."""
    r = np.random.default_rng(11)
    w = r.standard_normal((256, 384)).astype(np.float32)
    x = r.standard_normal((3, 256)).astype(np.float32)
    jq, tq = _carrier(w, 128)
    want = np.asarray(j_qmm(jnp.asarray(x, jnp.bfloat16), jq, interpret=True,
                            out_dtype=jnp.float32))
    got = t_qm.quant_matmul(torch.tensor(x).to(torch.bfloat16), tq, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=1e-2)
    jq32, tq32 = _carrier(w, 128, dtype=jnp.float32)
    want = np.asarray(j_qmm(jnp.asarray(x), jq32, interpret=True))
    got = t_qm.quant_matmul(torch.tensor(x), tq32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=1e-5)


def test_qmm_int4_indexed_matches_pallas():
    """Stacked [L, D/2, F] carrier addressed by layer: atol 2e-2 / rtol 1e-2
    in bf16 against quant_matmul_indexed, and each layer bitwise equal to the
    unstacked call on that layer's carriers."""
    r = np.random.default_rng(12)
    L, d, f = 3, 256, 512
    w = r.standard_normal((L, d, f)).astype(np.float32)
    x = r.standard_normal((4, d)).astype(np.float32)
    jq, tq = _carrier(w, 64, batch_dims=1)
    xt = torch.tensor(x).to(torch.bfloat16)
    for l in range(L):
        want = np.asarray(j_qmm_idx(jnp.asarray(x, jnp.bfloat16), jq, jnp.int32(l),
                                    interpret=True).astype(jnp.float32))
        got = t_qm.quant_matmul(xt, tq, layer=l)
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=1e-2)
        unit = t_qm.qmm_int4(xt, tq.q[l], tq.scale[l], tq.offset[l], group_size=64, n_out=f)
        assert torch.equal(got, unit)


def test_qmm_int4_plain_weight_is_the_dequantized_carrier():
    """The plain version's weight is ``dequantize`` bit for bit (f32), and a
    one-hot row of x returns that weight's row (the identity probe the CUDA
    kernel is held to on the card)."""
    g = torch.Generator().manual_seed(13)
    w = torch.randn((2, 128, 80), generator=g)
    qa = quantize(w, 4, 32, batch_dims=1, compute_dtype=torch.float32)
    for l in range(2):
        want = dequantize(type(qa)(qa.q[l], qa.scale[l], qa.offset[l], 4, 32, qa.shape, 1, 1,
                                   torch.float32, qa.rest_pad))
        got = t_qm.int4_weight(qa.q[l], qa.scale[l], qa.offset[l], 32)
        assert torch.equal(got, want)
        eye = torch.eye(128)[[0, 63, 64, 127]]  # rows in both halves of the plane
        probe = t_qm.qmm_int4(eye, qa.q, qa.scale, qa.offset, group_size=32, n_out=80, layer=l)
        assert torch.equal(probe, want[[0, 63, 64, 127]])


def test_qmm_int4_plain_rows_independent_of_row_count():
    """Rows of a 1-row call equal the same rows of 13- and 40-row calls."""
    g = torch.Generator().manual_seed(14)
    qa = quantize(torch.randn((256, 96), generator=g), 4, 64)
    x = torch.randn((40, 256), generator=g).to(torch.bfloat16)
    kw = dict(group_size=64, n_out=90)
    for m in (13, 40):
        full = t_qm.qmm_int4(x[:m], qa.q, qa.scale, qa.offset, **kw)
        for i in (0, m // 2, m - 1):
            one = t_qm.qmm_int4(x[i:i + 1], qa.q, qa.scale, qa.offset, **kw)
            assert torch.equal(one[0], full[i])


def test_qmm_int4_checks_shapes():
    q = torch.zeros((32, 16), dtype=torch.uint8)
    s = torch.ones((2, 16))
    with pytest.raises(ValueError):  # x does not contract with 2 * 32 rows
        t_qm.qmm_int4(torch.zeros((2, 32)), q, s, s, group_size=32, n_out=16)
    with pytest.raises(ValueError):  # scale rows do not match the group size
        t_qm.qmm_int4(torch.zeros((2, 64)), q, s, s, group_size=16, n_out=16)
    with pytest.raises(ValueError):  # unstacked carrier with a layer index
        t_qm.qmm_int4(torch.zeros((2, 64)), q, s, s, group_size=32, n_out=16, layer=0)
    with pytest.raises(ValueError):
        t_qm.qmm_int4(torch.zeros((2, 64)), q, s, s, group_size=32, n_out=17)
