"""The port's INT8/INT4 carriers are byte-identical to the JAX package's
(``flexflow_tpu/quant/weight_only.py``): quantize, concat_rest and
quantize_params; dequantize agrees exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import params as j_params
from flexflow_tpu.quant import weight_only as jw
from flexflow_tpu.specs import ModelSpec as JSpec
from flexflow_tpu_torch.models import params as t_params
from flexflow_tpu_torch.quant import weight_only as tw
from flexflow_tpu_torch.specs import ModelSpec as TSpec

torch.set_num_threads(2)


def _bytes(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def assert_same_carrier(t, j):
    """Byte-identical carriers and equal metadata."""
    assert (t.bits, t.group_size, tuple(t.shape), t.batch_dims, t.contract_dims,
            t.rest_pad) == (j.bits, j.group_size, tuple(j.shape), j.batch_dims,
                            j.contract_dims, j.rest_pad)
    np.testing.assert_array_equal(_bytes(t.q.numpy()), _bytes(j.q))
    np.testing.assert_array_equal(_bytes(t.scale.numpy()), _bytes(j.scale))
    if j.offset is None:
        assert t.offset is None
    else:
        np.testing.assert_array_equal(_bytes(t.offset.numpy()), _bytes(j.offset))


CASES = [  # shape, batch_dims, contract_dims, group_size
    ((64, 96), 0, 1, 32),
    ((2, 128, 4, 16), 1, 1, 64),  # per-layer [L, D, H, Dh]
    ((2, 4, 16, 128), 1, 2, 32),  # wo-style [L, H, Dh, D], contract (H, Dh)
    ((1024, 600), 0, 1, 128),  # rest_pad: d >= 1024, F >= 512 -> pad to 1024
    ((2, 1024, 520), 1, 1, 128),
    ((48, 40), 0, 1, 128),  # group size shrinks to divide d (or d/2)
    ((2, 3, 128, 96), 2, 1, 32),  # MoE experts [L, E, D, F]
]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,bd,cd,gs", CASES)
def test_quantize_byte_identical(bits, shape, bd, cd, gs):
    w = np.random.default_rng(hash((shape, bits)) % 2**32).standard_normal(shape).astype(np.float32)
    j = jw.quantize(jnp.asarray(w), bits, gs, batch_dims=bd, contract_dims=cd,
                    compute_dtype=jnp.float32)
    t = tw.quantize(torch.tensor(w), bits, gs, batch_dims=bd, contract_dims=cd,
                    compute_dtype=torch.float32)
    assert_same_carrier(t, j)
    np.testing.assert_array_equal(tw.dequantize(t).numpy(), np.asarray(jw.dequantize(j)))


def test_round_half_to_even():
    # w / scale lands exactly on .5 steps: jnp.round and torch.round both
    # round half to even
    w = np.array([[127.0], [0.5], [1.5], [2.5], [-0.5], [-2.5]], np.float32)
    j = jw.quantize(jnp.asarray(w), 8, 8, compute_dtype=jnp.float32)
    t = tw.quantize(torch.tensor(w), 8, 8, compute_dtype=torch.float32)
    assert_same_carrier(t, j)
    assert t.q[:, 0].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("bits", [8, 4])
def test_concat_rest_byte_identical(bits):
    r = np.random.default_rng(bits)
    ws = [r.standard_normal((2, 1024, n)).astype(np.float32) for n in (300, 300, 212)]
    jq = [jw.quantize(jnp.asarray(w), bits, 128, batch_dims=1, compute_dtype=jnp.float32)
          for w in ws]
    tq = [tw.quantize(torch.tensor(w), bits, 128, batch_dims=1, compute_dtype=torch.float32)
          for w in ws]
    assert_same_carrier(tw.concat_rest(tq, (812,)), jw.concat_rest(jq, (812,)))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_byte_identical(bits):
    kw = dict(arch="LlamaForCausalLM", vocab_size=96, hidden_size=64, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128)
    jp = j_params.init_params(JSpec(**kw), jax.random.PRNGKey(3), jnp.float32)
    tp = t_params.params_from_numpy(jax.tree.map(np.asarray, jp))
    jq = jw.quantize_params(JSpec(**kw), jp, bits=bits, group_size=32,
                            compute_dtype=jnp.float32)
    tq = tw.quantize_params(TSpec(**kw), tp, bits=bits, group_size=32,
                            compute_dtype=torch.float32)
    assert set(tq["layers"]) == set(jq["layers"])
    for name, leaf in jq["layers"].items():
        if isinstance(leaf, jw.QuantizedArray):
            assert_same_carrier(tq["layers"][name], leaf)
        else:
            np.testing.assert_array_equal(tq["layers"][name].numpy(), np.asarray(leaf))
    assert_same_carrier(tq["lm_head"], jq["lm_head"])
    np.testing.assert_array_equal(tq["embed_tokens"].numpy(), np.asarray(jq["embed_tokens"]))


def test_params_from_numpy_keeps_jax_carriers():
    w = np.random.default_rng(0).standard_normal((2, 64, 32)).astype(np.float32)
    j = jw.quantize(jnp.asarray(w), 4, 16, batch_dims=1, compute_dtype=jnp.float32)
    as_dict = {f: getattr(j, f) for f in ("q", "scale", "offset", "bits", "group_size",
                                          "shape", "batch_dims", "contract_dims", "rest_pad")}
    for leaf in (j, as_dict):
        t = t_params.params_from_numpy(leaf, dtype=torch.float32)
        assert_same_carrier(t, j)
