"""The port's ``seq`` mesh axis and its context-parallel attention ops held
against the JAX package on the CPU:

- ``make_mesh``'s coordinates: rank r of a 2 x 1 x 2 x 2 mesh sits at JAX's
  ``reshape(data, pipe, model, seq)`` coordinate with JAX's groups, and a
  mesh with ``seq == 1`` keeps its ranks and groups;
- ``ops/ring_attention``'s four functions over gloo ranks (spawned, the
  helpers of ``test_torch_port_mesh_serving.py``) against JAX's
  ``context_parallel_prefill`` / ``context_parallel_decode`` on its 8 CPU
  devices (C = 4, and T = 2 x C = 2): MHA / GQA / MQA, ``length``, bf16,
  decode at t = 1 and 4 and a tree mask, at JAX's own tolerances (2e-5 in
  f32, 2e-2 in bf16);
- the decode-attention kernel's shard form (``decode_attention_state``,
  ``tree_attention_state``) and ``merge_states`` on C = 1, 2 and 4 slices of
  one cache (their plain versions on the CPU) against JAX's
  ``split_cached_attention``.

Inputs are drawn with numpy from a seed and fed to both packages; the ranks
import no JAX.
"""

import numpy as np
import pytest
import torch

from test_torch_port_mesh_serving import _join, _start

F32_TOL, BF16_TOL = 2e-5, 2e-2  # JAX's tests/test_ring_attention.py


def _qkv(seed, s, h, kh, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(s, h, d).astype(np.float32), rng.randn(s, kh, d).astype(np.float32),
            rng.randn(s, kh, d).astype(np.float32))


def _decode_inputs(seed, b, t, h, kh, d, s):
    """q [B, T, H, D], the cache in JAX's [B, KH, D, S] layout, the new K/V."""
    rng = np.random.RandomState(seed)
    return dict(q=rng.randn(b, t, h, d), kc=rng.randn(b, kh, d, s), vc=rng.randn(b, kh, d, s),
                kn=rng.randn(b, t, kh, d), vn=rng.randn(b, t, kh, d))


def _tree_mask(t):
    """JAX's ``test_cp_cached_decode_tree_mask`` tree: 0 -> {1, 2}, 1 -> 3,
    2 -> 4 (siblings do not see each other)."""
    nm = np.eye(t, dtype=bool)
    nm[1, 0] = nm[2, 0] = True
    nm[3, [0, 1]] = True
    nm[4, [0, 2]] = True
    return nm[None]


PREFILL_CASES = {  # name: (mesh (data, pipe, model, seq), seed, S, H, KH, D, length, dtype)
    "mha": ((1, 1, 1, 4), 0, 64, 8, 8, 16, None, "float32"),
    "gqa": ((1, 1, 1, 4), 0, 64, 8, 2, 16, None, "float32"),
    "mqa": ((1, 1, 1, 4), 0, 64, 8, 1, 16, None, "float32"),
    "length": ((1, 1, 1, 4), 1, 64, 4, 4, 16, 37, "float32"),
    "bf16": ((1, 1, 1, 4), 2, 128, 4, 4, 32, None, "bfloat16"),
    "t2c2": ((1, 1, 2, 2), 5, 64, 4, 4, 16, None, "float32"),
}
DECODE_CASES = {  # name: (seed, B, T, H, KH, D, S, lens, tree)
    "t1": (3, 2, 1, 4, 2, 16, 64, [13, 48], False),
    "t4": (3, 2, 4, 4, 2, 16, 64, [13, 48], False),
    "tree": (4, 1, 5, 2, 2, 16, 64, [20], True),
}


def run_ring_ops(cases, model_dir):
    """Every rank: the ring prefill cases, then the decode cases, each on
    its mesh (the group made once a mesh shape)."""
    from flexflow_tpu_torch.ops import ring_attention as ring
    from flexflow_tpu_torch.parallel.mesh import make_mesh

    meshes, out = {}, {}
    for name, (shape, seed, s, h, kh, d, length, dt) in PREFILL_CASES.items():
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device="cpu")
        mesh = meshes[shape]
        q, k, v = (torch.from_numpy(x).to(getattr(torch, dt)) for x in _qkv(seed, s, h, kh, d))
        got = ring.context_parallel_prefill(mesh, q, k, v, length=length)
        out[f"prefill-{name}"] = (str(got.dtype), got.float().numpy())
    mesh = meshes[(1, 1, 1, 4)]
    for name, (seed, b, t, h, kh, d, s, lens, tree) in DECODE_CASES.items():
        x = {k: torch.from_numpy(v).float() for k, v in _decode_inputs(seed, b, t, h, kh, d,
                                                                        s).items()}
        kc, vc = x["kc"].transpose(2, 3), x["vc"].transpose(2, 3)  # the port's [B, KH, S, D]
        nm = torch.from_numpy(_tree_mask(t)) if tree else None
        got = ring.context_parallel_decode(mesh, x["q"], kc, vc, x["kn"], x["vn"],
                                           torch.tensor(lens), new_mask=nm)
        out[f"decode-{name}"] = got.numpy()
    return out


def test_mesh_coordinates_and_groups_are_jax():
    """Rank r of make_mesh(data=2, model=2, seq=2) sits at JAX's
    ``np.arange(8).reshape(2, 1, 2, 2)`` coordinate, and each group holds
    the ranks JAX's mesh lines up along that axis; seq == 1 meshes keep
    today's ranks (model fastest)."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh
    from flexflow_tpu_torch.parallel.mesh import Mesh

    jm = j_make_mesh(2, 1, 2, seq=2)
    ids = np.vectorize(lambda dv: dv.id)(jm.devices)  # [data, pipe, model, seq]
    for r in range(8):
        m = Mesh.fake(2, 2, r, seq=2)
        d, p, mm, c = m.data_rank, m.pipe_rank, m.model_rank, m.seq_rank
        assert ids[d, p, mm, c] == r
        assert m.group_ranks("model") == ids[d, p, :, c].tolist()
        assert m.group_ranks("data") == ids[:, p, mm, c].tolist()
        assert m.group_ranks("seq") == ids[d, p, mm, :].tolist()
        assert m.group_ranks("pipe") == ids[d, :, mm, c].tolist()
    for r in range(8):
        m = Mesh.fake(2, 2, r, pipe=2)
        assert (m.model_rank, m.pipe_rank, m.data_rank, m.seq_rank) == (r % 2, r // 2 % 2,
                                                                        r // 4, 0)


@pytest.mark.parametrize("c", [1, 2, 4])
def test_shard_form_and_merge_equal_jax_split_attention(c):
    """C slices of one cache through the shard form (each slice's state, the
    in-flight columns on slice 0) and ``merge_states`` give JAX's
    ``split_cached_attention`` at t = 1 and 4 and under the tree mask; the
    plain merge of the states gives the same."""
    import jax.numpy as jnp

    from flexflow_tpu.ops import attention as jattn
    from flexflow_tpu_torch.ops import attention as attn
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    for name, (seed, b, t, h, kh, d, s, lens, tree) in DECODE_CASES.items():
        x = _decode_inputs(seed, b, t, h, kh, d, s)
        nm = _tree_mask(t) if tree else None
        want = np.asarray(jattn.split_cached_attention(
            *(jnp.asarray(x[k], jnp.float32) for k in ("q", "kc", "vc", "kn", "vn")),
            jnp.asarray(lens, jnp.int32), new_mask=None if nm is None else jnp.asarray(nm)))
        tx = {k: torch.from_numpy(v).float() for k, v in x.items()}
        kc, vc = tx["kc"].transpose(2, 3), tx["vc"].transpose(2, 3)
        tl = torch.tensor(lens, dtype=torch.int32)
        w = s // c
        states = []
        for r in range(c):
            blk = (kc[:, :, r * w:(r + 1) * w], vc[:, :, r * w:(r + 1) * w])
            if t == 1:
                st = da.decode_attention_state(tx["q"][:, 0], *blk, tx["kn"][:, 0],
                                               tx["vn"][:, 0], tl, first=r * w,
                                               inflight=r == 0)[:, None]
            else:
                mask = (torch.from_numpy(nm) if tree else
                        torch.tril(torch.ones(t, t, dtype=torch.bool))[None]).expand(b, t, t)
                st = da.tree_attention_state(tx["q"], *blk, tx["kn"], tx["vn"], tl, mask,
                                             first=r * w, inflight=r == 0)
            states.append(st)
        every = torch.stack(states, dim=-2).reshape(b * t, h, c, d + 2)
        for merge in (da.merge_states, attn.merge_states):
            got = merge(every).reshape(b, t, h, d).numpy()
            np.testing.assert_allclose(got, want, atol=F32_TOL, err_msg=f"{name} C={c}")


def test_ring_ops_equal_jax_over_gloo_ranks(tmp_path):
    """The ring prefill (C = 4: MHA, GQA, MQA, ``length``, bf16; T = 2 x
    C = 2) and ``context_parallel_decode`` (C = 4: t = 1, t = 4, the tree
    mask) on 4 gloo ranks against JAX's ``context_parallel_prefill`` and
    ``context_parallel_decode`` on its CPU devices; every rank holds the
    same output."""
    import jax.numpy as jnp

    from flexflow_tpu.ops import ring_attention as jring
    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    started = _start(tmp_path, 4, [None], runner=run_ring_ops)
    jmeshes = {}
    want = {}
    for name, (shape, seed, s, h, kh, d, length, dt) in PREFILL_CASES.items():
        if shape not in jmeshes:
            jmeshes[shape] = j_make_mesh(*shape)
        q, k, v = (jnp.asarray(x, getattr(jnp, dt)) for x in _qkv(seed, s, h, kh, d))
        want[f"prefill-{name}"] = np.asarray(jring.context_parallel_prefill(
            jmeshes[shape], q, k, v, length=None if length is None else jnp.int32(length)),
            np.float32)
    for name, (seed, b, t, h, kh, d, s, lens, tree) in DECODE_CASES.items():
        x = {k: jnp.asarray(v, jnp.float32) for k, v in _decode_inputs(seed, b, t, h, kh, d,
                                                                        s).items()}
        want[f"decode-{name}"] = np.asarray(jring.context_parallel_decode(
            jmeshes[(1, 1, 1, 4)], x["q"], x["kc"], x["vc"], x["kn"], x["vn"],
            jnp.asarray(lens, jnp.int32),
            new_mask=jnp.asarray(_tree_mask(t)) if tree else None))
    res = _join(tmp_path, 4, started)
    for key, w in want.items():
        got = [r[key] for r in res]
        if key.startswith("prefill"):
            assert all(g[0] == got[0][0] for g in got)
            assert got[0][0] == ("torch.bfloat16" if key.endswith("bf16") else "torch.float32")
            got = [g[1] for g in got]
        assert all(np.array_equal(g, got[0]) for g in got[1:]), key
        tol = BF16_TOL if key.endswith("bf16") else F32_TOL
        np.testing.assert_allclose(got[0], w, atol=tol, err_msg=key)
