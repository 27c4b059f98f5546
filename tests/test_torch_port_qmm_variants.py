"""The dequant-matmul design variants' plain PyTorch versions
(``ops/kernels/qmm_variants.py``, what the wrappers run for CPU tensors)
against the JAX kernel bodies of ``benchmarks/tune_int4_variants.py`` run in
interpret mode, with ``_call``'s block shapes; the identity probe, the
wrappers' checks, and the port's tuning entry points on the CPU. The CUDA
kernels are tested on a GPU by tests/test_torch_port_cuda.py and
``python3 chip_smoke.py --only card,build,variants``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks import tune_int4_variants as j_tv
from flexflow_tpu.quant import weight_only as jw
from flexflow_tpu_torch.benchmarks import splitk_breakdown as t_sb
from flexflow_tpu_torch.benchmarks import tune_int4_variants as t_tv
from flexflow_tpu_torch.benchmarks import tune_quant_kernel as t_tq
from flexflow_tpu_torch.models import params as t_params
from flexflow_tpu_torch.ops.kernels import qmm_variants as t_qv
from flexflow_tpu_torch.ops.kernels import quant_matmul as t_qm
from flexflow_tpu_torch.quant.weight_only import quantize

torch.set_num_threads(2)

BODIES = {
    "i8_group": j_tv._i8_group_kernel,
    "i4_floor": j_tv._i4_floor_kernel,
    "i4_3dot": j_tv._i4_3dot_kernel,
    "i4_and": j_tv._i4_and_kernel,
    "i4_and_bigdot": j_tv._i4_and_bigdot_kernel,
    "i4_and_2dot": j_tv._i4_and_2dot_kernel,
}


def _jax_variant(name, x, jq, bf=256):
    """The JAX body in interpret mode, blocked as ``_call`` blocks it (without
    the TPU memory space): [B, Fp]."""
    b, d = x.shape
    fp, g, qrows = jq.q.shape[-1], jq.scale.shape[0], jq.q.shape[0]
    specs = [pl.BlockSpec((b, d), lambda j: (0, 0)),
             pl.BlockSpec((qrows, bf), lambda j: (0, j)),
             pl.BlockSpec((g, bf), lambda j: (0, j))]
    args = [x, jq.q, jq.scale]
    if jq.offset is not None:
        specs.append(pl.BlockSpec((g, bf), lambda j: (0, j)))
        args.append(jq.offset)
    return pl.pallas_call(
        functools.partial(BODIES[name], group_size=jq.group_size), grid=(fp // bf,),
        in_specs=specs, out_specs=pl.BlockSpec((b, bf), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((b, fp), x.dtype), interpret=True)(*args)


def _bits(name):
    return 8 if name == "i8_group" else 4


@pytest.mark.parametrize("name", t_qv.VARIANTS)
@pytest.mark.parametrize("d,f,g", [(1024, 512, 128), (2048, 1000, 64)], ids=["d1024", "d2048"])
def test_plain_matches_jax_body(name, d, f, g):
    """Same carrier (quantized by JAX, carried over byte for byte), bf16 x,
    B=8: max |diff| <= 2^-8 max |want| (one bf16 rounding at the largest
    output; the two sum the same products in other orders)."""
    r = np.random.default_rng(30)
    w = (r.standard_normal((d, f)) * 0.02).astype(np.float32)
    x = r.standard_normal((8, d)).astype(np.float32)
    jq = jw.quantize(jnp.asarray(w), _bits(name), g)
    tq = t_params.params_from_numpy(jq, dtype=torch.bfloat16)
    assert tq.group_size == g and tq.q.shape[-1] % 256 == 0
    want = np.asarray(_jax_variant(name, jnp.asarray(x, jnp.bfloat16), jq)
                      .astype(jnp.float32))[:, :f]
    before = dict(t_qv.LAUNCHES)
    got = t_qv.variant(name, torch.tensor(x).to(torch.bfloat16), tq)
    assert t_qv.LAUNCHES == before  # CPU tensors run the plain version
    assert got.shape == (8, f) and got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("d,f,g,m", [(256, 96, 32, 5), (1024, 1000, 128, 8), (200, 64, 25, 3)])
def test_bigdot_plain_equals_qmm_int4_plain(d, f, g, m):
    """``hi16 * (s / 16)`` is ``hi * s`` exactly in f32 (a power-of-two
    scaling), so the AND-unpacked weight is the production kernel's."""
    gen = torch.Generator().manual_seed(31)
    qa = quantize(torch.randn((d, f), generator=gen), 4, g)
    assert qa.group_size == g
    x = torch.randn((m, d), generator=gen).to(torch.bfloat16)
    got = t_qv.i4_and_bigdot_plain(x, qa.q, qa.scale, qa.offset, g, f)
    want = t_qm.qmm_int4_plain(x, qa.q, qa.scale, qa.offset, g, f, torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", t_qv.VARIANTS)
def test_plain_identity_probe(name):
    """One-hot rows of x (both planar halves) return the dequantized
    weight's rows rounded to bf16, bitwise: the groups other than the hot one
    add exact zeros, and the post-dot multiply and add round apart."""
    gen = torch.Generator().manual_seed(32)
    d, f, g = 512, 80, 64
    qa = quantize(torch.randn((d, f), generator=gen), _bits(name), g)
    if qa.bits == 8:
        w = qa.q.float() * torch.repeat_interleave(qa.scale, g, dim=0)
    else:
        w = t_qm.int4_weight(qa.q, qa.scale, qa.offset, g)
    rows = [0, 1, d // 2 - 1, d // 2, d - 1]
    eye = torch.eye(d, dtype=torch.bfloat16)[rows]
    assert torch.equal(t_qv.variant(name, eye, qa), w[rows, :f].to(torch.bfloat16))


@pytest.mark.parametrize("name", t_qv.VARIANTS)
def test_wrappers_check_arguments(name):
    """A device other than cuda or cpu, a group that does not divide D/2
    (INT4) or D (INT8), and a column width the kernel does not take raise."""
    fn = getattr(t_qv, name)
    bits = _bits(name)

    def call(d, g, device="cpu", cols=32):
        rows = d if bits == 8 else d // 2
        q = torch.zeros((rows, 32), dtype=torch.int8 if bits == 8 else torch.uint8,
                        device=device)
        tables = [torch.ones((d // g, 32), device=device)] * (1 if bits == 8 else 2)
        x = torch.zeros((2, d), dtype=torch.bfloat16, device=device)
        return fn(x, q, *tables, group_size=g, n_out=32, cols=cols)

    assert call(256, 64).shape == (2, 32)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        call(256, 64, device="meta")
    with pytest.raises(ValueError, match="does not divide"):
        call(*((192, 64) if bits == 4 else (320, 128)))  # 64 | 192 but not 96; 128 does not | 320
    with pytest.raises(ValueError, match="cols"):
        call(256, 64, cols=24)


def test_tuning_case_runner_on_cpu():
    """Every case of the tuning run at D=1024, F=1000, B=8 (the plain
    versions) within 1e-2 of max |x @ dequantize(qa)|; pattern filtering."""
    recs, data = t_tv.run(1024, 1000, 8, device="cpu", reps=1)
    names = [r["name"] for r in recs]
    assert data["x"].shape == (8, 1024) and data["qa"][4].q.shape == (512, 1024)
    assert all(data["rot"][bits][0] is data["qa"][bits] for bits in (8, 4))
    assert len(recs) == len(t_qv.VARIANTS) * len(t_tv.COLS) + 2
    assert names[-2:] == ["i8-prod", "i4-prod"] and "i4-and-2dot cols=64" in names
    assert all(r["ok"] and r["relerr"] < 1e-2 for r in recs), recs
    one, data = t_tv.run(1024, 1000, 8, device="cpu", reps=1, patterns=["i4-and cols=32"])
    assert [r["name"] for r in one] == ["i4-and cols=32"] and list(data["rot"]) == [4]
    recs = t_tq.run(1024, 1000, 8, device="cpu", reps=1)
    assert [r["name"] for r in recs] == ["bf16 GEMV", "int8 prod", "int4 prod", "int8 dequant",
                                         "int4 dequant"]
    assert all(r["ok"] and r["relerr"] < 1e-2 for r in recs), recs


def _raise(*a, **k):
    raise RuntimeError("a broken kernel")


def _zeros(x, *a, n_out, **k):
    return torch.zeros((x.shape[0], n_out), dtype=x.dtype)


@pytest.mark.parametrize("fault", [None, _raise, _zeros], ids=["none", "raises", "wrong"])
def test_tuning_clis_exit_nonzero_when_a_case_fails(monkeypatch, capsys, fault):
    small_v, small_q = t_tv.run, t_tq.run
    monkeypatch.setattr(t_tv, "run", lambda **kw: small_v(d=1024, **{**kw, "f": 1000}))
    monkeypatch.setattr(t_tq, "run", lambda **kw: small_q(d=1024, f=1000, **kw))
    if fault is not None:
        monkeypatch.setattr(t_qv, "i4_and", fault)
        monkeypatch.setattr(t_qm, "qmm_int4", fault)
    rc_v = t_tv.main(["--device", "cpu", "--reps", "1", "i4-and cols=16", "i8-group cols=16"])
    rc_q = t_tq.main(["--device", "cpu", "--reps", "1"])
    out = capsys.readouterr().out
    assert (rc_v, rc_q) == ((0, 0) if fault is None else (1, 1))
    assert ("FAILED" in out) == (fault is not None)
    assert "i8-group cols=16:" in out and "bf16 GEMV:" in out


def test_card_raises_when_nvidia_smi_fails(monkeypatch):
    """A GPU time is never printed without nvidia-smi's name and power limit."""
    def fail(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(t_tq.subprocess, "run", fail)
    assert t_tq.card(torch.device("cpu")).startswith("cpu")
    with pytest.raises(FileNotFoundError):
        t_tq.card(torch.device("cuda"))


# (m, d, n_out, group): the CUDA tests' shapes (7B, unaligned, long groups)
# and a shape whose units do not divide evenly among the splits
_SPLIT_SHAPES = [(8, 4096, 11008, 128), (1, 4096, 11008, 128), (4, 4096, 11008, 128),
                 (5, 1000, 190, 20), (8, 1000, 190, 20), (19, 1024, 256, 256),
                 (8, 1024, 256, 256), (8, 3584, 512, 128)]


@pytest.mark.parametrize("cols", (16, 32, 64, 128))
@pytest.mark.parametrize("name", t_qv.SPLIT_K)
def test_split_plan_covers_the_contraction(name, cols):
    """On 132, 8 and 1 SMs: the split is a whole number of groups (INT8) or
    group pairs (INT4) a block, the blocks along D cover it with none empty,
    the blocks' column tiles cover the output, and a block fits one SM (8
    warps, the shared memory)."""
    for m, d, f, g in _SPLIT_SHAPES:
        for sms in (132, 8, 1):
            p = t_qv.split_plan(name, m, d, f, g, cols, sms)
            span = 2 * g if name == "i4_and_2dot" else g  # x columns of a unit
            assert p.units * span == d
            assert (p.splits - 1) * p.units_per_block < p.units <= p.splits * p.units_per_block
            tiles = -(-f // cols)
            assert p.grid == (-(-tiles // p.tiles_per_block), -(-m // p.rows), p.splits)
            assert p.rows == (8 if m <= 8 else 16) and cols % p.warp_cols == 0
            assert p.threads == cols // p.warp_cols * p.tiles_per_block * 32 <= 256
            assert p.grid[0] * p.tiles_per_block * cols >= f
            assert p.smem <= 232448


def test_split_plan_workspace_shapes():
    """The workspace the wrapper asks for: [splits, tiles, column warps,
    sums a lane, 32 lanes] f32 (4 a 16-column subtile and n8 tile; INT4 keeps
    both halves' sums), one counter a tile, nothing when the blocks do not
    split D."""
    p = t_qv.split_plan("i8_group", 8, 4096, 11008, 128, 64, 132)
    assert (p.splits, p.warp_cols, p.tiles_per_block, p.units_per_block) == (6, 64, 8, 6)
    assert p.grid == (22, 1, 6) and p.ws_shape == (6, 22, 8, 16, 32) and p.tickets == 22
    p = t_qv.split_plan("i4_and_2dot", 19, 1024, 256, 256, 128, 132)
    assert p.warp_cols == 16 and p.ws_shape == (2, 4, 8, 16, 32) and p.tickets == 4
    p = t_qv.split_plan("i4_and_2dot", 8, 4096, 11008, 128, 16, 1)
    assert (p.splits, p.ws_shape, p.tickets) == (1, None, 0)
    assert t_qv._workspace(p, torch.device("cpu")) == (None, None)


@pytest.mark.parametrize("name", t_qv.SPLIT_K)
def test_split_k_wrapper_hands_the_kernel_its_plan(monkeypatch, name):
    """The wrapper's call on a non-CPU tensor (meta, with the library faked):
    the C entry's argument list as ``_build.SIGNATURES`` declares it, the
    plan's split, a workspace of its shape and the sizes of the workspace and
    the counters (which the launcher checks), counters allocated once per
    stream, one launch counted."""
    calls, spaces = [], []

    class Lib:
        def __getattr__(self, fn):
            return lambda *args: calls.append((fn, args)) or 0

    workspace = t_qv._workspace
    monkeypatch.setattr(t_qv._build, "lib", lambda: Lib())
    monkeypatch.setattr(t_qv._build, "stream_ptr", lambda device: 7)
    monkeypatch.setattr(t_qv, "_sm_count", lambda device: 132)
    monkeypatch.setattr(t_qv, "_TICKETS", {})
    monkeypatch.setattr(t_qv, "_check", lambda n, x, q, tables, *a: (x.shape[1], q.shape[1]))
    monkeypatch.setattr(t_qv, "_workspace",
                        lambda p, device: spaces.append(workspace(p, device)) or spaces[-1])
    int4 = name == "i4_and_2dot"
    d, fp, f, g = 4096, 11264, 11008, 128
    meta = dict(device="meta")
    x = torch.empty((8, d), dtype=torch.bfloat16, **meta)
    q = torch.empty((d // 2 if int4 else d, fp), dtype=torch.uint8 if int4 else torch.int8, **meta)
    tables = [torch.empty((d // g, fp), **meta) for _ in range(2 if int4 else 1)]
    before = t_qv.LAUNCHES[name]
    for _ in range(2):
        out = getattr(t_qv, name)(x, q, *tables, group_size=g, n_out=f, cols=64)
    assert out.shape == (8, f) and t_qv.LAUNCHES[name] == before + 2
    p = t_qv.split_plan(name, 8, d, f, g, 64, 132)
    fn, args = calls[0]
    assert fn == f"ff_qmm_v_{name}" and len(args) == len(t_qv._build.SIGNATURES[fn])
    ws, tk = spaces[0]
    assert args[-10:] == (8, d, fp, f, g, 64, p.splits, ws.numel(), tk.numel(), 7)
    assert [ws.shape for ws, _ in spaces] == [p.ws_shape] * 2
    assert spaces[1][1] is tk and tk.numel() >= p.tickets
    assert list(t_qv._TICKETS) == [(None, 7)]


@pytest.mark.parametrize("part", sorted(t_sb.PARTS))
def test_splitk_breakdown_switches_off_one_part(part):
    """Each of the breakdown's builds defines one bit of FF_SPLITK_OFF, a bit
    of its own, which the kernel's source tests; the kernel's own build
    defines none (the source's default, 0)."""
    src = t_sb._build.CSRC_DIR / "qmm_variants.cu"
    bit = t_sb.PARTS[part]
    assert bit & (bit - 1) == 0 and sorted(t_sb.PARTS.values()) == [1, 2, 4]
    args = t_sb.nvcc_args(src, part, "lib.so")
    assert [a for a in args if a.startswith("-D")] == [f"-DFF_SPLITK_OFF={bit}"]
    assert not [a for a in t_sb.nvcc_args(src, None, "lib.so") if a.startswith("-D")]
    text = src.read_text()
    assert "#define FF_SPLITK_OFF 0" in text and f"FF_SPLITK_OFF & {bit})" in text


@pytest.mark.parametrize("name", t_qv.SPLIT_K)
def test_split_candidates_are_the_plans_choices(name):
    """The splits the breakdown sweeps and the plan chooses from: rising,
    each a distinct block count along D with every block holding a unit, each
    fitting a block's shared memory, the plan's choice among them, and both
    memoised (the same objects on a second call)."""
    for m, d, f, g in _SPLIT_SHAPES:
        plans = t_qv.split_candidates(name, m, d, f, g, 32)
        splits = [p.splits for p in plans]
        assert splits == sorted(set(splits)) and splits[0] == 1
        assert all((p.splits - 1) * p.units_per_block < p.units and p.smem <= 232448
                   for p in plans)
        assert len({p.units_per_block for p in plans}) == len(plans)
        chosen = t_qv.split_plan(name, m, d, f, g, 32, 132)
        assert chosen in plans and t_qv.split_plan(name, m, d, f, g, 32, 132) is chosen
        assert t_qv.split_candidates(name, m, d, f, g, 32) is plans


def test_splitk_breakdown_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_sb.main(["--reps", "1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
