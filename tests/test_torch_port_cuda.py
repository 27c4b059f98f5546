"""The port's CUDA kernels against their plain PyTorch versions, on a GPU,
and the serving paths that run them (LLaMA, Mixtral, and LoRA adapters).

Every test here carries the ``cuda`` marker and skips without a CUDA device
(a kernel has no CPU mode). On a GPU machine without JAX, run them without
the JAX conftest: ``python -m pytest --noconftest tests/test_torch_port_cuda.py``.
This file imports nothing of JAX. ``python3 chip_smoke.py`` checks the same
kernels at LLaMA-2-7B shapes.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.models import decoder as t_decoder
from flexflow_tpu_torch.models import params as t_params
from flexflow_tpu_torch.ops.sampling import SamplingConfig
from flexflow_tpu_torch.ops.kernels import decode_attention as t_da
from flexflow_tpu_torch.ops.kernels import flash_prefill as t_fp
from flexflow_tpu_torch.ops.kernels import qmm_variants as t_qv
from flexflow_tpu_torch.ops.kernels import quant_matmul as t_qm
from flexflow_tpu_torch.peft import lora as t_lora
from flexflow_tpu_torch.quant import quantize_params
from flexflow_tpu_torch.quant.weight_only import QuantizedArray, quantize
from flexflow_tpu_torch.serving import graphs
from flexflow_tpu_torch.serving.engine import InferenceEngine
from flexflow_tpu_torch.serving.engine import _params_to as td_params_to
from flexflow_tpu_torch.models.layer_store import LayerStore
from flexflow_tpu_torch.serving.request_manager import GenerationConfig, RequestManager
from flexflow_tpu_torch.serving.spec_manager import SpecRequestManager
from flexflow_tpu_torch.serving.speculative import SpecEngine
from flexflow_tpu_torch.specs import ModelSpec, MoESpec

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


_T = t_qm.PREFILL_ROWS
_BF16, _F32 = torch.bfloat16, torch.float32
# each regime and its edges on a small carrier: decode (M <= 16), verify
# (M <= 128), the tiled kernel (below the prefill threshold), the two-pass
# prefill (from it); 32-column slabs, and 64-column ones from 8448 columns
_REGIME_CASES = [
    (512, 256, 256, 128, 1), (512, 256, 256, 128, 16), (512, 256, 256, 128, 17),
    (512, 256, 250, 128, 104), (512, 256, 256, 128, 128), (512, 256, 256, 128, 129),
    (512, 256, 256, 64, _T - 1), (512, 256, 240, 64, _T),
    (256, 8448, 8448, 128, 8), (256, 8448, 8400, 128, 104),
]


@pytest.mark.parametrize("d,fp,n_out,g,m", [
    (512, 200, 190, 128, 33),  # F not a multiple of 16: plain loads fill the ring
    (512, 256, 256, 128, 40),  # cp.async ring, verify tiling
    (520, 96, 96, 8, 5),  # D not a multiple of the chunk, groups of 8 rows
    (576, 128, 128, 64, 40),  # groups shorter than the 128-deep decode chunk
    (100, 40, 33, 25, 20),  # D not a multiple of 8, an odd group size
    *_REGIME_CASES,
])
def test_qmm_int8_kernel_matches_plain(cuda, d, fp, n_out, g, m):
    """bf16: within 1% of the output magnitude; each row bitwise equal to a
    1-row call (which takes the decode regime); f32 x: 1e-5 relative."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randint(-127, 128, (2, d, fp), generator=gen, device=cuda, dtype=torch.int8)
    s = torch.rand((2, d // g, fp), generator=gen, device=cuda) * 0.01
    x = torch.randn((m, d), generator=gen, device=cuda)
    xb = x.to(torch.bfloat16)
    got = t_qm.qmm_int8(xb, q, s, group_size=g, n_out=n_out, layer=1)
    want = t_qm.qmm_int8_plain(xb, q[1], s[1], g, n_out, torch.bfloat16)
    assert (got.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()
    for r in (0, m - 1):
        one = t_qm.qmm_int8(xb[r:r + 1].contiguous(), q, s, group_size=g, n_out=n_out, layer=1)
        assert torch.equal(one[0], got[r])
    got32 = t_qm.qmm_int8(x, q, s, group_size=g, n_out=n_out, layer=1)
    want32 = t_qm.qmm_int8_plain(x, q[1], s[1], g, n_out, torch.float32)
    assert (got32 - want32).abs().max() <= 1e-5 * want32.abs().max()


def _int4_carrier(gen, layers, d, fp, g):
    """A random planar INT4 carrier: packed bytes, positive scales and
    offsets of either sign (any byte value is a valid pair of nibbles)."""
    q = torch.randint(0, 256, (layers, d // 2, fp), generator=gen, device=gen.device,
                      dtype=torch.uint8)
    s = torch.rand((layers, d // g, fp), generator=gen, device=gen.device) * 0.01
    o = (torch.rand((layers, d // g, fp), generator=gen, device=gen.device) - 0.5) * 0.1
    return q, s, o


@pytest.mark.parametrize("d,fp,n_out,g,m", [
    (512, 200, 190, 128, 33),  # F not a multiple of 16: plain loads fill the ring
    (512, 256, 256, 64, 40),  # cp.async ring, verify tiling
    (512, 256, 250, 32, 5),  # groups shorter than the 128-deep decode chunk
    (400, 96, 96, 25, 20),  # an odd group size; D/2 not a multiple of the chunk
    (100, 40, 33, 5, 7),  # D not a multiple of 8
    *_REGIME_CASES,
])
def test_qmm_int4_kernel_matches_plain(cuda, d, fp, n_out, g, m):
    """bf16: within 1% of the output magnitude; each row bitwise equal to a
    1-row call (the decode regime); f32 x: 1e-5 relative."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, s, o = _int4_carrier(gen, 2, d, fp, g)
    x = torch.randn((m, d), generator=gen, device=cuda)
    xb = x.to(torch.bfloat16)
    kw = dict(group_size=g, n_out=n_out, layer=1)
    got = t_qm.qmm_int4(xb, q, s, o, **kw)
    want = t_qm.qmm_int4_plain(xb, q[1], s[1], o[1], g, n_out, torch.bfloat16)
    assert (got.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()
    for r in (0, m // 2, m - 1):
        one = t_qm.qmm_int4(xb[r:r + 1].contiguous(), q, s, o, **kw)
        assert torch.equal(one[0], got[r])
    got32 = t_qm.qmm_int4(x, q, s, o, **kw)
    want32 = t_qm.qmm_int4_plain(x, q[1], s[1], o[1], g, n_out, torch.float32)
    assert (got32 - want32).abs().max() <= 1e-5 * want32.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_qmm_int4_identity_probe(cuda, dtype):
    """One-hot rows of x give back the dequantized weight's rows bitwise (the
    weight rounded once to x's dtype), in both half-planes: the multiply and
    the add of the dequantization round apart, as in the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    d, fp, g = 256, 160, 32
    q, s, o = _int4_carrier(gen, 1, d, fp, g)
    w = t_qm.int4_weight(q[0], s[0], o[0], g).to(dtype)
    rows = [0, 1, 127, 128, 129, 255]
    eye = torch.eye(d, device=cuda, dtype=dtype)[rows].contiguous()
    got = t_qm.qmm_int4(eye, q, s, o, group_size=g, n_out=fp, layer=0)
    assert torch.equal(got, w[rows])


@pytest.mark.parametrize("m", [6, 17, 129, _T], ids=["decode", "verify", "tiled", "two-pass"])
def test_qmm_int4_identity_probe_each_regime(cuda, m):
    """The identity probe through each regime: one-hot rows (both
    half-planes) padded with zero rows up to m give back the weight's rows
    rounded to bf16, bitwise (the other half-plane adds an exact 0)."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    d, fp, g = 512, 256, 64
    q, s, o = _int4_carrier(gen, 2, d, fp, g)
    w = t_qm.int4_weight(q[1], s[1], o[1], g).to(torch.bfloat16)
    rows = [0, 1, 255, 256, 257, 511]
    eye = torch.zeros((m, d), device=cuda, dtype=torch.bfloat16)
    eye[torch.arange(len(rows)), rows] = 1
    got = t_qm.qmm_int4(eye, q, s, o, group_size=g, n_out=fp, layer=1)
    assert torch.equal(got[:len(rows)], w[rows])
    assert not got[len(rows):].any()


@pytest.mark.parametrize("bits", [8, 4])
def test_qmm_two_pass_stacked_layer_equals_unstacked(cuda, bits):
    """Layer 2 of a stacked carrier through the two-pass prefill gives the
    bits of an unstacked copy of that layer (the layer offset reaches the
    dequantization pass)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    d, fp, g, m = 512, 256, 128, _T
    assert t_qm.regime(m, d, fp, bits) == "two-pass"
    x = torch.randn((m, d), generator=gen, device=cuda).to(torch.bfloat16)
    if bits == 8:
        q = torch.randint(-127, 128, (3, d, fp), generator=gen, device=cuda, dtype=torch.int8)
        s = torch.rand((3, d // g, fp), generator=gen, device=cuda) * 0.01
        got = t_qm.qmm_int8(x, q, s, group_size=g, n_out=fp, layer=2)
        want = t_qm.qmm_int8(x, q[2].clone(), s[2].clone(), group_size=g, n_out=fp)
    else:
        q, s, o = _int4_carrier(gen, 3, d, fp, g)
        got = t_qm.qmm_int4(x, q, s, o, group_size=g, n_out=fp, layer=2)
        want = t_qm.qmm_int4(x, q[2].clone(), s[2].clone(), o[2].clone(), group_size=g, n_out=fp)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", t_qv.VARIANTS)
@pytest.mark.parametrize("d,f,g,b", [
    (4096, 11008, 128, 8),  # LLaMA-2-7B's MLP at decode rows (carrier padded to 11264)
    (1000, 190, 20, 5),  # F not a multiple of 16 and g of 8: plain loads fill the ring
    (1024, 256, 256, 19),  # groups longer than a 128-row step; two 16-row tiles of x
], ids=["7b", "unaligned", "long-groups"])
def test_qmm_variant_matches_plain_and_probe(cuda, name, d, f, g, b):
    """Each column width: within 1% of the output's magnitude of the plain
    version (the same products summed in another order, one bf16 rounding),
    and one-hot rows of x (both planar halves) return the dequantized
    weight's rows rounded to bf16, bitwise; one launch counted per call."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    bits = 8 if name == "i8_group" else 4
    qa = quantize(torch.randn((d, f), generator=gen, device=cuda) * 0.02, bits, g)
    assert qa.group_size == g
    x = torch.randn((b, d), generator=gen, device=cuda).to(torch.bfloat16)
    want = t_qv.plain(name, x, qa)
    if bits == 8:
        w = qa.q.float() * torch.repeat_interleave(qa.scale, g, dim=0)
    else:
        w = t_qm.int4_weight(qa.q, qa.scale, qa.offset, g)
    rows = [0, d // 2 - 1, d // 2, d - 1]
    eye = torch.eye(d, device=cuda, dtype=torch.bfloat16)[rows].contiguous()
    for cols in (16, 32, 64, 128):
        before = t_qv.LAUNCHES[name]
        got = t_qv.variant(name, x, qa, cols)
        assert got.shape == (b, f) and got.dtype == torch.bfloat16
        assert (got.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()
        assert torch.equal(t_qv.variant(name, eye, qa, cols), w[rows, :f].to(torch.bfloat16))
        assert t_qv.LAUNCHES[name] == before + 2


@pytest.mark.parametrize("name", t_qv.SPLIT_K)
@pytest.mark.parametrize("d,f,g,b", [
    (4096, 11008, 128, 1), (4096, 11008, 128, 8),
    (1000, 190, 20, 1), (1000, 190, 20, 8),
    (1024, 256, 256, 1), (1024, 256, 256, 8),
], ids=["7b-b1", "7b-b8", "unaligned-b1", "unaligned-b8", "long-groups-b1", "long-groups-b8"])
def test_split_k_variant_is_deterministic(cuda, name, d, f, g, b):
    """The split-K kernels at B = 1 and 8 on the shapes above, each column
    width: two calls give the same bits (the splits' sums are combined in a
    fixed order), within 1% of the output's magnitude of the plain version,
    one launch counted per call, and the per-stream counters left zeroed."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    qa = quantize(torch.randn((d, f), generator=gen, device=cuda) * 0.02,
                  8 if name == "i8_group" else 4, g)
    x = torch.randn((b, d), generator=gen, device=cuda).to(torch.bfloat16)
    want = t_qv.plain(name, x, qa)
    for cols in (16, 32, 64, 128):
        before = t_qv.LAUNCHES[name]
        got = t_qv.variant(name, x, qa, cols)
        assert torch.equal(t_qv.variant(name, x, qa, cols), got)
        assert t_qv.LAUNCHES[name] == before + 2
        assert (got.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()
        torch.cuda.synchronize()
        assert all(int(t.abs().sum()) == 0 for t in t_qv._TICKETS.values())


def test_split_k_kernel_refuses_a_split_past_the_groups(cuda, monkeypatch):
    """More blocks along D than it has groups: the kernel's launcher refuses
    with cudaErrorInvalidValue (1), and the wrapper raises."""
    qa = quantize(torch.randn((1024, 256), device=cuda), 8, 128)  # 8 groups
    x = torch.randn((8, 1024), device=cuda).to(torch.bfloat16)
    plan = t_qv.split_plan
    monkeypatch.setattr(t_qv, "split_plan",
                        lambda *a: dataclasses.replace(plan(*a), splits=9, ws_shape=(1 << 22,),
                                                       tickets=1024))
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        t_qv.variant("i8_group", x, qa, 32)


@pytest.mark.parametrize("name", t_qv.SPLIT_K)
def test_split_k_kernel_refuses_a_workspace_too_small(cuda, name):
    """The launcher works its geometry out itself: a workspace one float
    short of the plan's, or one counter short of a tile each, is refused with
    cudaErrorInvalidValue (1) before anything is written; the plan's own sizes
    launch and give the plain version's output."""
    int4 = name == "i4_and_2dot"
    qa = quantize(torch.randn((4096, 1024), device=cuda) * 0.02, 4 if int4 else 8, 128)
    x = torch.randn((8, 4096), device=cuda).to(torch.bfloat16)
    p = t_qv.split_plan(name, 8, 4096, 1024, 128, 32, t_qv._sm_count(x.device))
    assert p.splits > 1
    tables = [qa.scale] + ([qa.offset] if int4 else [])
    ws = torch.zeros(p.ws_shape, dtype=torch.float32, device=cuda).flatten()
    tk = torch.zeros(p.tickets, dtype=torch.int32, device=cuda)
    fn = getattr(t_qv._build.lib(), f"ff_qmm_v_{name}")

    def launch(out, n_ws, n_tk):
        return fn(x.data_ptr(), qa.q.data_ptr(), *[t.data_ptr() for t in tables], out.data_ptr(),
                  ws.data_ptr(), tk.data_ptr(), 8, 4096, qa.q.shape[-1], 1024, 128, 32, p.splits,
                  n_ws, n_tk, t_qv._build.stream_ptr(x.device))

    out = torch.full((8, 1024), 7.0, dtype=torch.bfloat16, device=cuda)
    assert launch(out, ws.numel() - 1, p.tickets) == 1
    assert launch(out, ws.numel(), p.tickets - 1) == 1
    torch.cuda.synchronize()
    assert bool((out == 7.0).all()) and int(ws.abs().sum()) == 0 and int(tk.abs().sum()) == 0
    assert launch(out, ws.numel(), p.tickets) == 0
    want = t_qv.plain(name, x, qa).float()
    assert (out.float() - want).abs().max() <= 1e-2 * want.abs().max()
    torch.cuda.synchronize()
    assert int(tk.abs().sum()) == 0


_C = t_da.CHUNK
# (B, H, KH, S, D, dtype, lengths): rows of length 0, 1 and at the chunk's
# edges (C - 1, C, C + 1: the token itself the last of a chunk or the first
# of the next), a 4096-position row (65 chunks), every head dim, GQA groups
# of 4, 8 and 16, MQA, bf16 and f32
_DECODE_CASES = {
    "f32-g4-d64": (3, 8, 2, 100, 64, _F32, [0, 37, 100]),
    "edges-bf16": (6, 8, 8, 200, 128, _BF16, [0, 1, _C - 1, _C, _C + 1, 200]),
    "edges-f32": (6, 8, 8, 200, 128, _F32, [0, 1, _C - 1, _C, _C + 1, 200]),
    "s4096": (1, 4, 4, 4096, 128, _BF16, [4096]),
    **{f"d{d}": (2, 4, 2, 130, d, _BF16, [130, _C]) for d in t_da._HEAD_DIMS},
    "d256-f32": (2, 4, 2, 130, 256, _F32, [_C + 1, 3]),
    "g4": (2, 16, 4, 150, 128, _BF16, [150, _C - 1]),
    "g8": (2, 32, 4, 150, 128, _BF16, [2 * _C, 9]),
    "g16": (2, 32, 2, 150, 64, _F32, [150, 0]),
    "mqa": (2, 16, 1, 150, 128, _BF16, [_C + 1, 1]),
    "mqa-g32-f32": (1, 32, 1, 300, 64, _F32, [300]),
}


@pytest.mark.parametrize("case", list(_DECODE_CASES), ids=list(_DECODE_CASES))
def test_decode_attention_kernel_matches_plain(cuda, case):
    """bf16, per element: one output rounding (2^-7 of |want|) plus 2^-12 of
    sum p|v| (f32 softmax and P.V: fast exp, summation order); f32: atol
    1e-4 (fast exp, summation order). One launch counted per call."""
    b, h, kh, s, d, dtype, lens_l = _DECODE_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(1)
    args = [torch.randn(sh, generator=g, device=cuda).to(dtype)
            for sh in ((b, h, d), (b, kh, s, d), (b, kh, s, d), (b, kh, d), (b, kh, d))]
    lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
    before = t_da.LAUNCHES
    got = t_da.decode_attention(*args, lens)
    assert t_da.LAUNCHES == before + 1
    want = t_da.decode_attention_plain(*args, lens)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs()
    if dtype == _BF16:
        a = [x.float() for x in args]
        pv = t_da.decode_attention_plain(a[0], a[1], a[2].abs(), a[3], a[4].abs(), lens)
        assert (err <= 2.0 ** -7 * want.float().abs() + 2.0 ** -12 * pv).all()
    else:
        assert err.max() <= 1e-4


def test_decode_attention_takes_misaligned_views(cuda):
    """q and cache views that start 2 bytes past a 16-byte boundary (copied
    by the wrapper) give the aligned inputs' output bitwise."""
    g = torch.Generator(device=cuda).manual_seed(5)
    b, h, s, d = 2, 4, 90, 64

    def shifted(*shape):
        flat = torch.randn(torch.Size(shape).numel() + 1, generator=g, device=cuda).to(_BF16)
        return flat[1:].view(*shape)

    args = [shifted(b, h, d), shifted(b, h, s, d), shifted(b, h, s, d), shifted(b, h, d),
            shifted(b, h, d)]
    assert all(x.data_ptr() % 16 for x in args)
    lens = torch.tensor([90, _C + 3], dtype=torch.int32, device=cuda)
    got = t_da.decode_attention(*args, lens)
    assert torch.equal(got, t_da.decode_attention(*[x.clone() for x in args], lens))


def test_decode_attention_refuses_another_chunk(cuda):
    """The C side checks the wrapper's copy of the chunk size and refuses a
    launch with another one (cudaErrorInvalidValue)."""
    from flexflow_tpu_torch.ops.kernels import _build

    b, h, s, d = 1, 2, 8, 32
    q = torch.zeros((b, h, d), device=cuda)
    kc = torch.zeros((b, h, s, d), device=cuda)
    lens = torch.zeros((b,), dtype=torch.int32, device=cuda)
    _, ws_shape = t_da.plan(q, kc)
    ws = torch.empty(ws_shape, device=cuda)
    out = torch.empty_like(q)
    err = _build.lib().ff_decode_attention(
        q.data_ptr(), kc.data_ptr(), kc.data_ptr(), q.data_ptr(), q.data_ptr(),
        lens.data_ptr(), None, None, None, out.data_ptr(), ws.data_ptr(), b, 1, h, h, s, d,
        _C + 1, 1.0, 0, _build.stream_ptr(cuda))
    assert err == 1  # cudaErrorInvalidValue


def test_decode_attention_captures_in_cuda_graph(cuda):
    """A call captured in a CUDA graph (no host read of cache_lens, the
    workspace allocated from the graph's pool) replays with new lengths
    and gives the eager call's bits."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, h, kh, s, d = 4, 8, 8, 300, 128
    args = [torch.randn(sh, generator=g, device=cuda).to(_BF16)
            for sh in ((b, h, d), (b, kh, s, d), (b, kh, s, d), (b, kh, d), (b, kh, d))]
    lens = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=cuda)
    t_da.decode_attention(*args, lens)  # warm up: the kernels built and loaded
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = t_da.decode_attention(*args, lens)
    lens.copy_(torch.tensor([300, 0, _C, 129], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, t_da.decode_attention(*args, lens))


def _tree(gen, b, width, depth):
    """Random trees in the speculative layout (slot 0 the root, slot
    1 + (d-1) * W + w beam w at depth d): parents and the ancestor mask."""
    t = 1 + width * depth
    parents = torch.full((b, t), -1, dtype=torch.long)
    parents[:, 1:1 + width] = 0
    for d in range(2, depth + 1):
        base, prev = 1 + (d - 1) * width, 1 + (d - 2) * width
        parents[:, base:base + width] = prev + torch.randint(0, width, (b, width), generator=gen)
    anc = torch.zeros((b, t, t), dtype=torch.bool)
    for c in range(t):
        anc[:, c, c] = True
        if c:
            anc[:, c] |= anc[torch.arange(b), parents[:, c]]
    return parents, anc


@pytest.mark.parametrize("dtype,h,kh,d", [
    (torch.bfloat16, 8, 2, 64), (torch.float32, 8, 2, 64),
    # GQA groups of 8 and MQA: a block holds fewer than all 13 nodes of a slot
    (torch.bfloat16, 16, 2, 128), (torch.float32, 16, 1, 64),
], ids=["bf16", "f32", "g8-d128-bf16", "mqa-g16-f32"])
def test_tree_attention_matches_plain_and_incremental_bits(cuda, dtype, h, kh, d):
    """The tree form against its plain version (bf16: one output rounding
    plus 2^-12 of sum p|v|, as decode attention; f32: 1e-4), and each node
    bitwise equal to the one-token call after its ancestors were committed
    into the cache (what incremental decoding computes), also where a
    node's path crosses a chunk boundary."""
    g = torch.Generator().manual_seed(6)
    b, s, width, depth = 5, 136, 3, 4
    t = 1 + width * depth
    _, anc = _tree(g, b, width, depth)
    # slots 3 and 4: a depth-4 path from C - 2 (or 2C - 3) crosses a chunk
    # boundary, the token itself on the far side
    lens = torch.tensor([0, 17, 60, _C - 2, 2 * _C - 3], dtype=torch.int32)
    q, kn, vn = (torch.randn(sh, generator=g).to(dtype)
                 for sh in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d)))
    kc, vc = (torch.randn((b, kh, s, d), generator=g).to(dtype) for _ in range(2))
    dev = [x.to(cuda) for x in (q, kc, vc, kn, vn, lens, anc)]
    got = t_da.tree_attention(*dev)
    want = t_da.tree_attention_plain(*dev)
    err = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        pv = t_da.tree_attention_plain(dev[0].float(), dev[1].float(), dev[2].float().abs(),
                                       dev[3].float(), dev[4].float().abs(), dev[5], dev[6])
        assert (err <= 2.0 ** -7 * want.float().abs() + 2.0 ** -12 * pv).all()
    else:
        assert err.max() <= 1e-4
    for bi in range(b):
        for c in range(t):
            path = anc[bi, c].nonzero()[:, 0].tolist()  # ancestors ascending, then c
            n = int(lens[bi])
            ck, cv = kc[bi:bi + 1].clone(), vc[bi:bi + 1].clone()
            for j, a in enumerate(path[:-1]):  # commit the ancestors at n, n+1, ...
                ck[0, :, n + j] = kn[bi, a]
                cv[0, :, n + j] = vn[bi, a]
            one = t_da.decode_attention(
                q[bi:bi + 1, c].to(cuda), ck.to(cuda), cv.to(cuda), kn[bi:bi + 1, c].to(cuda),
                vn[bi:bi + 1, c].to(cuda),
                torch.tensor([n + len(path) - 1], dtype=torch.int32, device=cuda))
            assert torch.equal(one[0], got[bi, c])


@pytest.mark.parametrize("dtype,tree", [(torch.bfloat16, False), (torch.float32, False),
                                        (torch.bfloat16, True), (torch.float32, True)],
                         ids=["bf16", "f32", "tree-bf16", "tree-f32"])
def test_shard_form_and_merge_match_plain_and_one_device(cuda, dtype, tree):
    """K5's shard form on C = 1, 2 and 4 slices of a cache (slots on a
    shard boundary and shards with no position) and ``merge_states``: the
    plain state and merge's output within the K5 limit, and at C = 1 the
    one-device kernel's bits."""
    g = torch.Generator().manual_seed(8)
    b, s, h, kh, d = 5, 256, 8, 2, 64
    t = 1 + 3 * 4 if tree else 1
    lens = torch.tensor([0, 17, 64, 128, 250], dtype=torch.int32)
    q = torch.randn((b, t, h, d), generator=g).to(dtype)
    kn, vn = (torch.randn((b, t, kh, d), generator=g).to(dtype) for _ in range(2))
    kc, vc = (torch.randn((b, kh, s, d), generator=g).to(dtype) for _ in range(2))
    anc = _tree(g, b, 3, 4)[1] if tree else None
    dev = [x.to(cuda) for x in (q, kc, vc, kn, vn, lens)]
    mask = anc.to(cuda) if tree else None
    one = (t_da.tree_attention(*dev, mask) if tree else
           t_da.decode_attention(dev[0][:, 0], dev[1], dev[2], dev[3][:, 0], dev[4][:, 0],
                                 dev[5])[:, None])
    for c in (1, 2, 4):
        w = s // c
        got, want = [], []
        for r in range(c):
            kb, vb = (x[:, :, r * w:(r + 1) * w].contiguous() for x in dev[1:3])
            kw = dict(first=r * w, inflight=r == 0)
            if tree:
                got.append(t_da.tree_attention_state(dev[0], kb, vb, *dev[3:], mask, **kw))
                want.append(t_da.tree_attention_state_plain(dev[0], kb, vb, *dev[3:], mask, **kw))
            else:
                args = (dev[0][:, 0], kb, vb, dev[3][:, 0], dev[4][:, 0], dev[5])
                got.append(t_da.decode_attention_state(*args, **kw)[:, None])
                want.append(t_da.decode_attention_state_plain(*args, **kw)[:, None])
        merged = [m(torch.stack(x, -2).reshape(b * t, h, c, d + 2), dtype).reshape(b, t, h, d)
                  for m, x in ((t_da.merge_states, got), (t_da.merge_states_plain, want))]
        err = (merged[0].float() - merged[1].float()).abs()
        if dtype == torch.bfloat16:
            assert (err <= 2.0 ** -7 * merged[1].float().abs() + 2.0 ** -12).all()
        else:
            assert err.max() <= 1e-4
        if c == 1:
            assert torch.equal(merged[0], one)


# (B, S, H, KH, D, dtype, lengths): the kernel's edges - rows of length 0
# and 1, S not a multiple of the 64-position tile, GQA groups of 4, 8 and
# 64 (one position a tile), each instantiated head dim (32, 64, 128, 256)
# and one that runs zero-padded on the next (80), and a 2048-position row
# (32 K/V tiles through the ring)
_FLASH_CASES = {
    "gqa4-s150-d64": (2, 150, 8, 2, 64, _BF16, [150, 61]),
    "len0-len1": (3, 70, 4, 4, 128, _BF16, [0, 1, 70]),
    "len0-len1-f32": (3, 70, 4, 4, 64, _F32, [0, 1, 70]),
    "s100-d128": (2, 100, 8, 8, 128, _BF16, [100, 99]),
    "g4-s77": (2, 77, 16, 4, 128, _BF16, [77, 40]),
    "g8-s90": (2, 90, 32, 4, 64, _BF16, [90, 33]),
    "g64-s40": (1, 40, 64, 1, 64, _BF16, [40]),
    "d32": (2, 70, 4, 2, 32, _BF16, [70, 9]),
    "d80": (2, 100, 4, 4, 80, _BF16, [100, 50]),
    "d256": (2, 130, 4, 2, 256, _BF16, [130, 65]),
    "s2048": (1, 2048, 4, 4, 128, _BF16, [2048]),
}


@pytest.mark.parametrize("case", list(_FLASH_CASES), ids=list(_FLASH_CASES))
def test_flash_prefill_kernel_matches_plain(cuda, case):
    """bf16, per element: one output rounding (2^-7 of |want|) plus twice the
    worst case of bf16 probabilities in P.V (2^-8 of sum p|v|); f32: atol
    1e-4 (fast exp, summation order). Rows at or past their length are
    zeros, and nothing is NaN."""
    b, s, h, kh, d, dtype, lens_l = _FLASH_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((b, s, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, s, kh, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, s, kh, d), generator=g, device=cuda).to(dtype)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
    got = t_fp.flash_prefill(q, k, v, lens)
    want = t_fp.flash_prefill_plain(q, k, v, lens)
    assert bool(torch.isfinite(got).all())
    for i, n in enumerate(lens_l):
        assert not got[i, n:].any()
    err = (got.float() - want.float()).abs()
    if dtype == _BF16:
        pv = t_fp.flash_prefill_plain(q.float(), k.float(), v.float().abs(), lens)
        assert (err <= 2.0 ** -7 * want.float().abs() + 2.0 ** -8 * pv).all()
    else:
        assert err.max() <= 1e-4


def test_flash_prefill_kernel_takes_misaligned_views(cuda):
    """q/k/v views that start 2 bytes past a 16-byte boundary (copied by the
    wrapper) give the aligned inputs' output bitwise."""
    g = torch.Generator(device=cuda).manual_seed(4)
    b, s, h, d = 2, 70, 4, 64

    def shifted():
        flat = torch.randn(b * s * h * d + 1, generator=g, device=cuda).to(_BF16)
        return flat[1:].view(b, s, h, d)

    q, k, v = shifted(), shifted(), shifted()
    assert all(t.data_ptr() % 16 for t in (q, k, v))
    lens = torch.tensor([70, 31], dtype=torch.int32, device=cuda)
    got = t_fp.flash_prefill(q, k, v, lens)
    assert torch.equal(got, t_fp.flash_prefill(q.clone(), k.clone(), v.clone(), lens))


def test_flash_prefill_kernel_f32_matches_plain(cuda):
    """f32 (the full-precision path): atol 1e-4 (fast exp, summation order)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, s, h, kh, d = 2, 130, 8, 8, 128
    q, k, v = (torch.randn(sh, generator=g, device=cuda)
               for sh in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    lens = torch.tensor([130, 64], dtype=torch.int32, device=cuda)
    got = t_fp.flash_prefill(q, k, v, lens)
    want = t_fp.flash_prefill_plain(q, k, v, lens)
    assert (got - want).abs().max() <= 1e-4


@pytest.mark.parametrize("bits", [None, 8], ids=["fp32", "int8"])
def test_f32_serving_on_cuda_matches_cpu(cuda, bits):
    """A tiny GQA LLaMA served at float32 through the kernels (flash prefill,
    decode attention, and the INT8 FMA matmul) gives the plain CPU path's
    greedy tokens exactly."""
    spec = ModelSpec(arch="LlamaForCausalLM", vocab_size=256, hidden_size=128, num_layers=2,
                     num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
                     max_position_embeddings=128, norm_eps=1e-5)
    params = t_params.init_params(spec, 0, torch.float32, "cpu")
    if bits:
        params = quantize_params(spec, params, bits=bits, group_size=32,
                                 compute_dtype=torch.float32)
    prompts = [[5, 17, 3, 99, 42], list(range(1, 40)), [7] * 12]
    outs = {}
    for dev in ("cpu", cuda):
        engine = InferenceEngine(spec, params, max_requests_per_batch=2, max_seq_len=96,
                                 cache_dtype=torch.float32, device=dev)
        rm = RequestManager(engine, decode_horizon=4, pipelined=True)
        try:
            reqs = rm.generate(prompts, GenerationConfig(max_new_tokens=12))
        finally:
            rm.close()
        outs[str(dev)] = [r.output_tokens for r in reqs]
    assert outs["cuda"] == outs["cpu"]
    assert all(len(t) == 12 for t in outs["cpu"])


def test_f32_int4_speculative_serving_on_cuda_matches_cpu(cuda):
    """A tiny f32 INT4 verifier with a smaller draft, served speculatively
    (fused, pipelined horizon 2) through the kernels, gives the CPU path's
    greedy tokens exactly; the INT4 kernel, decode attention (the draft's
    root step) and flash prefill all launch."""
    llm = ModelSpec(arch="LlamaForCausalLM", vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
                    max_position_embeddings=128, norm_eps=1e-5)
    ssm = ModelSpec(arch="LlamaForCausalLM", vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=2, num_kv_heads=1, head_dim=32, intermediate_size=128,
                    max_position_embeddings=128, norm_eps=1e-5)
    lp = quantize_params(llm, t_params.init_params(llm, 0, torch.float32, "cpu"), bits=4,
                         group_size=32, compute_dtype=torch.float32)
    sp = t_params.init_params(ssm, 1, torch.float32, "cpu")
    prompts = [[5, 17, 3, 99, 42], list(range(1, 40)), [7] * 12]
    outs = {}
    before = (t_qm.LAUNCHES_INT4, t_da.LAUNCHES, t_fp.LAUNCHES)
    for dev in ("cpu", cuda):
        engine = SpecEngine(llm, lp, ssm, sp, beam_width=2, beam_depth=3,
                            max_requests_per_batch=2, max_seq_len=112,
                            cache_dtype=torch.float32, device=dev)
        rm = SpecRequestManager(engine, fused=True, spec_horizon=2, pipelined=True)
        outs[str(dev)] = [r.output_tokens
                          for r in rm.generate(prompts, GenerationConfig(max_new_tokens=12))]
    assert outs["cuda"] == outs["cpu"]
    assert all(len(t) == 12 for t in outs["cpu"])
    after = (t_qm.LAUNCHES_INT4, t_da.LAUNCHES, t_fp.LAUNCHES)
    assert all(a > b for a, b in zip(after, before))


def test_bf16_int4_speculative_serving_equals_incremental_on_cuda(cuda):
    """bf16 activations, INT4 verifier: tree verification through the
    kernels gives incremental decoding's tokens exactly (row-invariant
    quant-matmul, and tree attention repeating the one-token arithmetic)."""
    llm = ModelSpec(arch="LlamaForCausalLM", vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
                    max_position_embeddings=256, norm_eps=1e-5)
    ssm = ModelSpec(arch="LlamaForCausalLM", vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=2, num_kv_heads=1, head_dim=32, intermediate_size=128,
                    max_position_embeddings=256, norm_eps=1e-5)
    lp = quantize_params(llm, t_params.init_params(llm, 2, torch.bfloat16, cuda), bits=4,
                         group_size=32, compute_dtype=torch.bfloat16)
    sp = t_params.init_params(ssm, 3, torch.bfloat16, cuda)
    prompts = [[5, 17, 3, 99, 42], list(range(1, 40)), [7] * 12, [200, 3]]
    cfg = GenerationConfig(max_new_tokens=24)
    incr = RequestManager(InferenceEngine(llm, lp, max_requests_per_batch=4, max_seq_len=192,
                                          cache_dtype=torch.bfloat16, device=cuda),
                          decode_horizon=4, pipelined=True)
    try:
        want = [r.output_tokens for r in incr.generate(prompts, cfg)]
    finally:
        incr.close()
    engine = SpecEngine(llm, lp, ssm, sp, beam_width=3, beam_depth=4, max_requests_per_batch=4,
                        max_seq_len=192, cache_dtype=torch.bfloat16, device=cuda)
    rm = SpecRequestManager(engine, fused=True, spec_horizon=2, pipelined=True)
    got = [r.output_tokens for r in rm.generate(prompts, cfg)]
    assert got == want


def test_wrappers_count_launches(cuda):
    before = (t_qm.LAUNCHES, t_qm.LAUNCHES_INT4, t_da.LAUNCHES, t_fp.LAUNCHES)
    test_flash_prefill_kernel_matches_plain(cuda, "gqa4-s150-d64")
    test_decode_attention_kernel_matches_plain(cuda, "f32-g4-d64")
    test_qmm_int4_identity_probe(cuda, torch.float32)
    assert (t_qm.LAUNCHES_INT4, t_da.LAUNCHES, t_fp.LAUNCHES) == (
        before[1] + 1, before[2] + 1, before[3] + 1)
    assert t_qm.LAUNCHES == before[0]


# ---------------------------------------------------------------------------
# the serving horizons as CUDA-graph replays (serving/graphs.py)
# ---------------------------------------------------------------------------

_TINY = dict(arch="LlamaForCausalLM", vocab_size=256, hidden_size=128, num_layers=2,
             num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
             max_position_embeddings=512, norm_eps=1e-5)
_DRAFT = dict(_TINY, hidden_size=64, num_heads=2, num_kv_heads=1, intermediate_size=128)


def _tiny_params(spec, seed, dtype, bits, device):
    params = t_params.init_params(spec, seed, dtype, device)
    if bits:
        params = quantize_params(spec, params, bits=bits, group_size=32, compute_dtype=dtype)
    return params


def _fill_cache(cache, seed):
    g = torch.Generator(device=cache.k.device).manual_seed(seed)
    for c in cache:
        c.copy_(torch.randn(c.shape, generator=g, device=c.device))


def _decode_engine(cuda, dtype, bits, s=160):
    spec = ModelSpec(**_TINY)
    eng = InferenceEngine(spec, _tiny_params(spec, 0, dtype, bits, cuda), max_requests_per_batch=4,
                          max_seq_len=s, cache_dtype=dtype, device=cuda)
    _fill_cache(eng.cache, 1)
    return eng


def _restore(cache, saved):
    for c, x in zip(cache, saved):
        c.copy_(x)


@pytest.mark.parametrize("dtype,bits", [(_F32, None), (_BF16, 8), (_BF16, 4)],
                         ids=["f32", "bf16-int8", "bf16-int4"])
def test_captured_decode_horizon_equals_uncaptured(cuda, dtype, bits):
    """Replays of the captured greedy step give the uncaptured body's tokens
    and cache bitwise, n = 1, 2 and 16, with slots that cross K5's
    64-position chunk edge and one whose last step writes position S - 1."""
    eng = _decode_engine(cuda, dtype, bits)
    s = eng.max_seq_len
    toks = [3, 17, 101, 250]
    for n in (1, 2, 16):
        lens = [60, 63, 130, s - n]
        saved = tuple(c.clone() for c in eng.cache)
        want = eng.greedy_horizon_async(lens, toks, n, replay=False)
        want_cache = tuple(c.clone() for c in eng.cache)
        _restore(eng.cache, saved)
        got = eng.greedy_horizon_async(lens, toks, n, replay=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert all(torch.equal(c, w) for c, w in zip(eng.cache, want_cache))
        assert not torch.equal(want_cache[0], saved[0])
    assert list(eng.graphs.graphs) == [None] and eng.graphs.replays == 19


def _spec_engine(cuda, s=512):
    llm, ssm = ModelSpec(**_TINY), ModelSpec(**_DRAFT)
    eng = SpecEngine(llm, _tiny_params(llm, 2, _BF16, 4, cuda), ssm,
                     _tiny_params(ssm, 3, _BF16, None, cuda), beam_width=3, beam_depth=4,
                     max_requests_per_batch=4, max_seq_len=s, cache_dtype=_BF16, device=cuda)
    prompts = [[5, 17, 3, 99, 42], list(range(1, 70)), [7] * 12, [200, 3]]
    first = eng.prefill_both_batch(prompts, [0, 1, 2, 3])
    return eng, eng._h([len(p) for p in prompts]), eng._h(first)


def test_captured_spec_iterations_equal_uncaptured(cuda):
    """Three replayed greedy iterations under two window buckets (128 and
    the full cache) give the uncaptured iterations' produced tokens, counts,
    lens, roots and both caches bitwise; every bucket is captured once."""
    eng, lens, roots = _spec_engine(cuda)
    for window in (128, None):
        saved = [c.clone() for cache in (eng.llm_cache, eng.ssm_cache) for c in cache]
        want = eng.greedy_horizon_async(lens, roots, 3, window, replay=False)
        want_caches = [c.clone() for cache in (eng.llm_cache, eng.ssm_cache) for c in cache]
        _restore([*eng.llm_cache, *eng.ssm_cache], saved)
        got = eng.greedy_horizon_async(lens, roots, 3, window, replay=True)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(torch.equal(c, w) for c, w in
                   zip([*eng.llm_cache, *eng.ssm_cache], want_caches))
        assert (want[1] >= 1).all()
    assert list(eng.graphs.graphs) == eng.window_buckets() == [128, 256, None]
    assert eng.graphs.replays == 6


def test_step_bodies_read_nothing_on_the_host(cuda):
    """One eager run of each captured body under sync debug mode "error":
    no host read (``.item()``, ``.cpu()``, ``nonzero``...) on the path."""
    eng = _decode_engine(cuda, _BF16, 8)
    eng._load(np.array([60, 63, 130, 5], np.int32), [3, 17, 101, 250])
    spec, lens, roots = _spec_engine(cuda)
    spec._load(lens, roots)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            eng._greedy_body()
            spec._greedy_body(128)
            spec._greedy_body(None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_replays_count_the_eager_launches(cuda):
    """After capture, n replays add to every launch counter what n
    uncaptured steps add (decode: qmm_int4 and decode_attention; spec:
    qmm_int4, both K5 forms)."""
    def growth(fn):
        before = graphs.launch_counts()
        fn()
        torch.cuda.synchronize()
        return tuple(a - b for a, b in zip(graphs.launch_counts(), before))

    eng = _decode_engine(cuda, _BF16, 4)
    lens, toks = [60, 63, 130, 5], [3, 17, 101, 250]
    eng.greedy_horizon_async(lens, toks, 1, replay=True)  # captures
    eager = growth(lambda: eng.greedy_horizon_async(lens, toks, 3, replay=False))
    replayed = growth(lambda: eng.greedy_horizon_async(lens, toks, 3, replay=True))
    # 4 fused projections x 2 layers + the lm_head; one K5 call a layer
    assert replayed == eager and eager[1] == 3 * 9 and eager[2] == 3 * 2
    spec, lens, roots = _spec_engine(cuda)
    spec.greedy_horizon_async(lens, roots, 1, None, replay=True)  # captures
    eager = growth(lambda: spec.greedy_horizon_async(lens, roots, 3, None, replay=False))
    replayed = growth(lambda: spec.greedy_horizon_async(lens, roots, 3, None, replay=True))
    assert replayed == eager and eager[1] > 0 and eager[2] > 0


def test_pipelined_horizon_tokens_survive_the_next_replay(cuda):
    """A horizon's returned tokens are its own copy: replaying the next
    horizon (fed from them, as the pipelined manager does) leaves them as
    the uncaptured body gave them."""
    eng = _decode_engine(cuda, _BF16, 8)
    lens, toks = np.array([60, 63, 130, 5], np.int32), [3, 17, 101, 250]
    saved = tuple(c.clone() for c in eng.cache)
    want = eng.greedy_horizon_async(lens, toks, 4, replay=False).clone()
    _restore(eng.cache, saved)
    first = eng.greedy_horizon_async(lens, toks, 4, replay=True)
    second = eng.greedy_horizon_async(lens + 4, first[-1], 4, replay=True)
    torch.cuda.synchronize()
    assert torch.equal(first, want) and second.shape == (4, 4)


def test_replays_resume_after_a_sampled_request_retires(cuda):
    """A sampled request runs eagerly beside a greedy one (2 slots, horizon
    4, pipelined); once it retires, every greedy step of the greedy request
    and of a later all-greedy batch is a replay."""
    spec = ModelSpec(**_TINY)
    eng = InferenceEngine(spec, _tiny_params(spec, 0, _BF16, 8, cuda), max_requests_per_batch=2,
                          max_seq_len=128, cache_dtype=_BF16, device=cuda)
    rm = RequestManager(eng, decode_horizon=4, pipelined=True)
    try:
        g = rm.register_request([5, 17, 3, 99, 42], GenerationConfig(max_new_tokens=40))
        rm.register_request([9, 1, 4], GenerationConfig(max_new_tokens=2, temperature=0.8))
        rm.run_until_idle()
        assert len(rm.get_request(g).output_tokens) == 40
        # the sampled slot's horizons: those dispatched before its retirement
        # was fetched, at most the pipeline's depth (2) of 4 steps
        assert eng.graphs.replays >= rm.total_decoding_steps - 2 * 4 > 0
        replays0, steps0 = eng.graphs.replays, rm.total_decoding_steps
        reqs = rm.generate([[5, 17, 3, 99, 42], [7, 7, 7]], GenerationConfig(max_new_tokens=24))
        torch.cuda.synchronize()
    finally:
        rm.close()
    assert eng.graphs.replays - replays0 == rm.total_decoding_steps - steps0 > 0
    assert reqs[0].output_tokens == rm.get_request(g).output_tokens[:24]


def test_engines_with_graphs_free_their_memory_without_gc(cuda):
    """An engine that has captured its graphs is freed, weights, cache and
    graph pool, as soon as the last reference goes: no reference cycle
    holds it until a garbage collection."""
    gc.collect()
    gc.disable()
    try:
        eng = _decode_engine(cuda, _BF16, 8)
        eng.greedy_horizon_async([60, 63, 130, 5], [3, 17, 101, 250], 2, replay=True)
        spec, lens, roots = _spec_engine(cuda)
        spec.greedy_horizon_async(lens, roots, 2, None, replay=True)
        torch.cuda.synchronize()
        caches = [c.numel() * c.element_size()
                  for e in (eng.cache, spec.llm_cache, spec.ssm_cache) for c in e]
        held = torch.cuda.memory_allocated()
        refs = [weakref.ref(eng), weakref.ref(spec)]
        del eng, spec, lens, roots
        assert all(r() is None for r in refs)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() <= held - sum(caches)
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# Mixtral (MoE): the expert-indexed quant-matmul and the captured MoE step
# ---------------------------------------------------------------------------

_TINY_MOE = dict(_TINY, arch="MixtralForCausalLM", moe=MoESpec(num_experts=4, top_k=2))


def test_qmm_int8_expert_index_matches_plain(cuda):
    """quant_matmul(layer=l, expert=e) on an [L, E, D, F] INT8 stack, in the
    decode, verify and two-pass regimes: within 1% of the output's magnitude
    of the plain version on the same slab, and bitwise equal to the kernel
    on that expert's slab copied out as a carrier of its own (so the flat
    offset l * E + e lands on the right bytes)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    d, f = 512, 384
    stack = quantize(torch.randn((2, 3, d, f), generator=gen, device=cuda) * 0.05, 8, 128,
                     batch_dims=2)
    for m in (8, 40, _T + 8):
        x = torch.randn((m, d), generator=gen, device=cuda).to(_BF16)
        for layer, e in ((0, 0), (1, 2), (0, 2), (1, 0)):
            got = t_qm.quant_matmul(x, stack, layer=layer, expert=e)
            want = t_qm.qmm_int8_plain(x, stack.q[layer, e], stack.scale[layer, e], 128, f, _BF16)
            assert (got.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()
            own = QuantizedArray(stack.q[layer, e].clone(), stack.scale[layer, e].clone(), None,
                                 8, 128, (d, f), 0, 1, _BF16, stack.rest_pad)
            assert torch.equal(got, t_qm.quant_matmul(x, own))


def _moe_engine(cuda, impl="dense"):
    spec = ModelSpec(**{**_TINY_MOE, "moe": MoESpec(num_experts=4, top_k=2, impl=impl)})
    return InferenceEngine(spec, _tiny_params(spec, 0, _BF16, 8, cuda), max_requests_per_batch=4,
                           max_seq_len=160, cache_dtype=_BF16, device=cuda)


def test_captured_mixtral_decode_horizon_equals_uncaptured(cuda):
    """Replays of the captured greedy step of a dense-MoE model (bf16, INT8
    group 32) give the uncaptured body's tokens and cache bitwise; replays
    count the eager launches: per step 2 + 3 x 4 qmm_int8 calls a layer plus
    the lm_head, one decode_attention call a layer."""
    eng = _moe_engine(cuda)
    _fill_cache(eng.cache, 1)
    lens, toks = [60, 63, 130, 5], [3, 17, 101, 250]
    for n in (1, 16):
        saved = tuple(c.clone() for c in eng.cache)
        want = eng.greedy_horizon_async(lens, toks, n, replay=False)
        want_cache = tuple(c.clone() for c in eng.cache)
        _restore(eng.cache, saved)
        got = eng.greedy_horizon_async(lens, toks, n, replay=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert all(torch.equal(c, w) for c, w in zip(eng.cache, want_cache))
    before = graphs.launch_counts()
    eng.greedy_horizon_async(lens, toks, 3, replay=True)
    grown = tuple(a - b for a, b in zip(graphs.launch_counts(), before))
    assert grown == (3 * (2 * (2 + 3 * 4) + 1), 0, 3 * 2, 0)


def test_mixtral_step_body_reads_nothing_on_the_host(cuda):
    """The dense MoE step under sync debug mode "error": no host read."""
    eng = _moe_engine(cuda)
    eng._load(np.array([60, 63, 130, 5], np.int32), [3, 17, 101, 250])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            eng._greedy_body()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_ragged_mixtral_serves_eagerly_with_the_dense_tokens(cuda):
    """A ragged-MoE engine captures nothing and serves every horizon
    eagerly; its greedy tokens (bf16, INT8) equal the dense form's, whose
    horizons are replays."""
    prompts = [[5, 17, 3, 99, 42], list(range(1, 40)), [7] * 12]
    outs = {}
    for impl in ("dense", "ragged"):
        eng = _moe_engine(cuda, impl)
        rm = RequestManager(eng, decode_horizon=4, pipelined=True)
        try:
            outs[impl] = [r.output_tokens
                          for r in rm.generate(prompts, GenerationConfig(max_new_tokens=12))]
        finally:
            rm.close()
        assert (eng.graphs is None) == (impl == "ragged")
        if impl == "dense":
            assert eng.graphs.replays > 0
    assert outs["ragged"] == outs["dense"]


# ---------------------------------------------------------------------------
# LoRA: routed adapters in the served step and on the card's kernels
# ---------------------------------------------------------------------------

_ALL7 = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def _lora_stacks(spec, n, dtype, device, seed=7):
    """n adapters at rank 4 on all seven projections, A and B from a seeded
    generator (B non-zero, so every adapter acts)."""
    cfg = t_lora.LoraConfig(rank=4, alpha=8.0, target_modules=_ALL7)
    gen = torch.Generator(device=device).manual_seed(seed)
    lora = t_lora.init_lora_params(spec, cfg, n, gen, dtype, device)
    for ab in lora.values():
        ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen, device=device) * 0.05)
    return lora, cfg


def test_captured_lora_decode_horizon_equals_uncaptured(cuda):
    """A LoRA engine (bf16, INT8, 3 adapters, slots routed [0, 2, -1, 1]):
    replays of the captured step give the uncaptured body's tokens and
    cache bitwise, the body reads nothing on the host, and the -1 slot's
    tokens equal a no-LoRA engine's on the same weights."""
    spec = ModelSpec(**_TINY)
    params = _tiny_params(spec, 0, _BF16, 8, cuda)
    lora, cfg = _lora_stacks(spec, 3, _BF16, cuda)
    eng = InferenceEngine(spec, params, max_requests_per_batch=4, max_seq_len=160,
                          cache_dtype=_BF16, device=cuda, lora=lora, lora_config=cfg)
    plain = InferenceEngine(spec, eng.params, max_requests_per_batch=4, max_seq_len=160,
                            cache_dtype=_BF16, device=cuda)
    _fill_cache(eng.cache, 1)
    _fill_cache(plain.cache, 1)
    lens, toks, ids = [60, 63, 130, 5], [3, 17, 101, 250], [0, 2, -1, 1]
    for n in (1, 16):
        saved = tuple(c.clone() for c in eng.cache)
        want = eng.greedy_horizon_async(lens, toks, n, replay=False, adapter_ids=ids)
        want_cache = tuple(c.clone() for c in eng.cache)
        _restore(eng.cache, saved)
        got = eng.greedy_horizon_async(lens, toks, n, replay=True, adapter_ids=ids)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert all(torch.equal(c, w) for c, w in zip(eng.cache, want_cache))
        _restore(eng.cache, saved)
    base = plain.greedy_horizon_async(lens, toks, 16, replay=True)
    assert torch.equal(got[:, 2], base[:, 2]) and not torch.equal(got, base)
    eng._load(np.array(lens, np.int32), toks, ids)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            eng._greedy_body()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_lora_delta_on_cuda_matches_cpu(cuda):
    """A float32 prefill and decode step with rows routed [1, -1, 0] through
    the kernels on the card against the plain path on the CPU: logits and
    each row's LoRA delta (LoRA minus base logits) within 1e-4 of their
    magnitude; the -1 row bitwise the card's no-LoRA forward."""
    spec = ModelSpec(**{**_TINY, "max_position_embeddings": 128})
    params = _tiny_params(spec, 0, _F32, 8, "cpu")
    lora, cfg = _lora_stacks(spec, 2, _F32, "cpu")
    ids = [1, -1, 0]
    toks = np.random.default_rng(3).integers(0, 256, (3, 24)).astype(np.int32)
    lens = np.array([24, 17, 9], np.int32)
    out = {}
    for dev in ("cpu", cuda):
        p = td_params_to(params, dev)
        routed = t_lora.route_lora(td_params_to(lora, dev))
        kw = dict(lora=routed, adapter_ids=torch.tensor(ids, device=dev),
                  lora_scale=t_lora.lora_scaling(cfg))
        tok = torch.as_tensor(toks, device=dev)
        pos = torch.arange(24, dtype=torch.int32, device=dev)[None].expand(3, 24)
        ln = torch.as_tensor(lens, device=dev)
        res = []
        for extra in (kw, {}):
            cache = t_decoder.init_kv_cache(spec, 3, 64, _F32, dev)
            with torch.no_grad():
                lg, (k, v) = t_decoder.forward(spec, p, tok, pos, lengths=ln, flash=True,
                                               return_kv=True, logits_at=ln - 1, **extra)
                t_decoder.commit_kv_windows(cache.k, cache.v, k.permute(0, 1, 3, 2, 4),
                                            v.permute(0, 1, 3, 2, 4), [0, 0, 0])
                step, _ = t_decoder.forward_cached(spec, p, lg.argmax(-1)[:, None].int(), cache,
                                                   ln, **extra)
            res.append(torch.stack([lg, step[:, 0]]))
        out[str(dev)] = res
    (gl, gb), (cl, cb) = out["cuda"], out["cpu"]
    assert (gl.cpu() - cl).abs().max() <= 1e-4 * cl.abs().max()
    delta_g, delta_c = (gl - gb).cpu(), cl - cb
    assert (delta_g - delta_c).abs().max() <= 1e-4 * delta_c.abs().max()
    assert delta_c[:, [0, 2]].abs().max() > 1e-2
    assert torch.equal(gl[:, 1], gb[:, 1])


@pytest.mark.parametrize("bits,dtype,m", [(8, _BF16, 8), (8, _BF16, 256), (8, _F32, 40),
                                          (4, _BF16, 104), (4, _F32, 8)])
def test_quant_matmul_fn_dx_on_card_matches_plain(cuda, bits, dtype, m):
    """Under a gradient the card's quant-matmul still launches the kernel
    (its count rises) through QuantMatmulFn, and the Function's dx equals
    autograd of the plain dequant + matmul: 1% of the magnitude in bf16
    (the sums' order and the product's dtype differ), 1e-5 in f32."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    qa = quantize(torch.randn((3, 512, 384), generator=gen, device=cuda) * 0.05, bits, 128,
                  batch_dims=1)
    x = torch.randn((m, 512), generator=gen, device=cuda).to(dtype).requires_grad_()
    xp = x.detach().clone().requires_grad_()
    counter = "LAUNCHES" if bits == 8 else "LAUNCHES_INT4"
    before, calls = getattr(t_qm, counter), t_qm.BACKWARD_CALLS
    out = t_qm.quant_matmul(x, qa, layer=2)
    want = t_qm.quant_matmul_plain(xp, qa, layer=2)
    assert getattr(t_qm, counter) == before + 1
    dy = torch.randn(out.shape, generator=gen, device=cuda).to(out.dtype)
    out.backward(dy)
    want.backward(dy)
    assert t_qm.BACKWARD_CALLS == calls + 1
    rel = 1e-2 if dtype == _BF16 else 1e-5
    for got, ref in ((out, want), (x.grad, xp.grad)):
        assert got.dtype == ref.dtype == dtype
        assert (got.float() - ref.float()).abs().max() <= rel * ref.float().abs().max()


@pytest.mark.parametrize("bits", [8, 4])
def test_finetune_steps_on_card_match_cpu(cuda, bits):
    """Four SGD finetuning steps of slot 1 on a tiny f32 quantized LLaMA
    through the kernels and QuantMatmulFn on the card: losses and the
    trained slot within 1e-4 of the CPU's plain path, slot 0 unchanged."""
    from flexflow_tpu_torch.peft.finetune import FinetuneSession

    spec = ModelSpec(**_TINY)
    params = _tiny_params(spec, 0, _F32, bits, "cpu")
    lora, cfg = _lora_stacks(spec, 2, _F32, "cpu")
    cfg = t_lora.LoraConfig(rank=cfg.rank, alpha=cfg.alpha, target_modules=cfg.target_modules,
                            learning_rate=0.05)
    toks = np.random.default_rng(5).integers(0, 256, (2, 33)).astype(np.int32)
    data = [(toks[:, :-1], toks[:, 1:])]
    out = {}
    for dev in ("cpu", cuda):
        engine = InferenceEngine(spec, params, max_requests_per_batch=2, max_seq_len=64,
                                 cache_dtype=_F32, device=dev, lora=lora, lora_config=cfg)
        slot0 = {m: a[..., :4].clone() for m, a in engine.lora.a.items()}
        session = FinetuneSession(spec, cfg, 1, data, epochs=4)
        launches = t_qm.LAUNCHES + t_qm.LAUNCHES_INT4
        while not session.tick(engine):
            pass
        if dev != "cpu":
            assert t_qm.LAUNCHES + t_qm.LAUNCHES_INT4 > launches
        assert all(torch.equal(engine.lora.a[m][..., :4], a) for m, a in slot0.items())
        out[str(dev)] = (session.losses, t_lora.unroute_lora(engine.lora))
    (lg, sg), (lc, sc) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert lc[-1] < lc[0]
    for m in sc:
        for k in ("a", "b"):
            ref = sc[m][k][:, 1]
            assert (sg[m][k][:, 1].cpu() - ref).abs().max() <= 1e-4 * ref.abs().max()


# ---------------------------------------------------------------------------
# several drafts (MultiSSMSpecManager) and a MoE model under SpecEngine
# ---------------------------------------------------------------------------


def _merged_tree(gen, b, shapes):
    """The merged tree of one random draft tree per (width, depth) in
    ``shapes`` (tokens from a 3-token vocabulary, so prefixes are shared):
    parents [B, T] (-2: a padding slot) and the ancestor mask."""
    from flexflow_tpu_torch.serving.tree_merge import merge_batch

    trees = []
    for w, d in shapes:
        parents, _ = _tree(gen, b, w, d)
        tokens = torch.randint(0, 3, parents.shape, generator=gen)
        tokens[:, 0] = 0
        trees.append((tokens.numpy(), parents.numpy()))
    t = 1 + sum(w * d for w, d in shapes)
    parents = torch.as_tensor(merge_batch(trees, t, t)[1], dtype=torch.long)
    anc = torch.eye(t, dtype=torch.bool).repeat(b, 1, 1)
    for c in range(1, t):
        ok = parents[:, c] >= 0
        anc[ok, c] |= anc[ok.nonzero()[:, 0], parents[ok, c]]
    return parents, anc


@pytest.mark.parametrize("tree", ["gqa", "merged"])
def test_tree_attention_gqa_and_merged_trees_match_incremental_bits(cuda, tree):
    """K5's tree form at Mixtral's GQA (32 query heads on 8) and on the
    merged tree of two drafts (19 slots, irregular parents, padding slots
    that attend only themselves): each node bitwise equal to the one-token
    call after its ancestors were committed, within the plain version's
    bf16 limit."""
    g = torch.Generator().manual_seed(9)
    b, s = 4, 200
    if tree == "gqa":
        h, kh, d = 32, 8, 128
        _, anc = _tree(g, b, 3, 4)
    else:
        h, kh, d = 8, 8, 128
        parents, anc = _merged_tree(g, b, [(3, 4), (1, 6)])
        assert anc.shape[-1] == 19 and (parents == -2).any()
    t = anc.shape[-1]
    lens = torch.tensor([0, 63, 64, 150], dtype=torch.int32)
    q, kn, vn = (torch.randn(sh, generator=g).to(_BF16)
                 for sh in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d)))
    kc, vc = (torch.randn((b, kh, s, d), generator=g).to(_BF16) for _ in range(2))
    dev = [x.to(cuda) for x in (q, kc, vc, kn, vn, lens, anc)]
    got = t_da.tree_attention(*dev)
    want = t_da.tree_attention_plain(*dev)
    pv = t_da.tree_attention_plain(dev[0].float(), dev[1].float(), dev[2].float().abs(),
                                   dev[3].float(), dev[4].float().abs(), dev[5], dev[6])
    assert ((got.float() - want.float()).abs()
            <= 2.0 ** -7 * want.float().abs() + 2.0 ** -12 * pv).all()
    for bi in range(b):
        for c in range(t):
            path = anc[bi, c].nonzero()[:, 0].tolist()
            n = int(lens[bi])
            ck, cv = kc[bi:bi + 1].clone(), vc[bi:bi + 1].clone()
            for j, a in enumerate(path[:-1]):
                ck[0, :, n + j] = kn[bi, a]
                cv[0, :, n + j] = vn[bi, a]
            one = t_da.decode_attention(
                q[bi:bi + 1, c].to(cuda), ck.to(cuda), cv.to(cuda), kn[bi:bi + 1, c].to(cuda),
                vn[bi:bi + 1, c].to(cuda),
                torch.tensor([n + len(path) - 1], dtype=torch.int32, device=cuda))
            assert torch.equal(one[0], got[bi, c])


def _two_draft_engines(cuda):
    """Draft A (width 3, depth 4) and draft B (width 1, depth 6) on one bf16
    INT4 verifier's tensors and cache, four requests admitted into all three
    caches; returns (engines, lens, roots)."""
    llm, ssm = ModelSpec(**_TINY), ModelSpec(**_DRAFT)
    a = SpecEngine(llm, _tiny_params(llm, 2, _BF16, 4, cuda), ssm,
                   _tiny_params(ssm, 3, _BF16, None, cuda), beam_width=3, beam_depth=4,
                   max_requests_per_batch=4, max_seq_len=256, cache_dtype=_BF16, device=cuda)
    b = SpecEngine(llm, a.llm_params, ssm, _tiny_params(ssm, 4, _BF16, None, cuda),
                   beam_width=1, beam_depth=6, max_requests_per_batch=4, max_seq_len=256,
                   cache_dtype=_BF16, device=cuda, llm_cache=a.llm_cache)
    prompts = [[5, 17, 3, 99, 42], list(range(1, 70)), [7] * 12, [200, 3]]
    first = a.prefill_both_batch(prompts, [0, 1, 2, 3])
    b.prefill_ssm_only(prompts, [0, 1, 2, 3])
    return [a, b], a._h([len(p) for p in prompts]), a._h(first)


def test_rotation_turns_replayed_equal_uncaptured(cuda):
    """Turns of draft A, B, A (each one greedy iteration, B's after a
    catch-up) replayed from one state give the uncaptured turns' outputs and
    all three caches (the shared verifier cache, each draft's) bitwise: both
    engines' graphs read the one verifier cache by address."""
    engines, lens, roots = _two_draft_engines(cuda)
    a, b = engines
    assert a.llm_cache.k.data_ptr() == b.llm_cache.k.data_ptr()
    caches = [*a.llm_cache, *a.ssm_cache, *b.ssm_cache]
    saved = [c.clone() for c in caches]

    def turns(replay):
        outs, ln, rt, prev = [], lens, roots, None
        for eng in (a, b, a):
            if prev is not None:  # catch up over the tokens the last turn committed
                eng.catchup(*(x.cpu().numpy() for x in prev))
            p, n, ln_next, rt = eng.greedy_horizon_async(ln, rt, 1, None, replay=replay)
            prev, ln = (ln, p[0]), ln_next
            outs += [p, n, ln, rt]
        return outs

    want = [x.clone() for x in turns(False)]
    want_caches = [c.clone() for c in caches]
    _restore(caches, saved)
    got = turns(True)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(c, w) for c, w in zip(caches, want_caches))
    assert a.graphs.replays == 2 and b.graphs.replays == 1


@pytest.mark.parametrize("merged", [False, True], ids=["rotation", "merged"])
def test_f32_two_drafts_on_cuda_match_cpu(cuda, merged):
    """A tiny f32 INT4 verifier with two drafts, rotated (every iteration a
    replay) or merged, through the kernels gives the CPU path's greedy
    tokens exactly, which are incremental decoding's."""
    from flexflow_tpu_torch.serving.spec_manager import MultiSSMSpecManager

    llm, ssm = ModelSpec(**_TINY), ModelSpec(**_DRAFT)
    lp = _tiny_params(llm, 0, _F32, 4, "cpu")
    drafts = [(_tiny_params(ssm, 1, _F32, None, "cpu"), 2, 3),
              (_tiny_params(ssm, 5, _F32, None, "cpu"), 1, 4)]
    prompts = [[5, 17, 3, 99, 42], list(range(1, 40)), [7] * 12]
    cfg = GenerationConfig(max_new_tokens=12)
    outs = {}
    for dev in ("cpu", cuda):
        engines = []
        for sp, w, d in drafts:
            first = engines[0] if engines else None
            engines.append(SpecEngine(
                llm, first.llm_params if first else lp, ssm, sp, beam_width=w, beam_depth=d,
                max_requests_per_batch=2, max_seq_len=160, cache_dtype=_F32, device=dev,
                llm_cache=first.llm_cache if first else None))
        rm = MultiSSMSpecManager(engines, merged=merged, fused=not merged)
        outs[str(dev)] = [r.output_tokens for r in rm.generate(prompts, cfg)]
        if dev is cuda:
            replays = sum(e.graphs.replays for e in engines)
            assert replays == (0 if merged else rm.total_decoding_steps)
    incr = RequestManager(InferenceEngine(llm, lp, max_requests_per_batch=2, max_seq_len=160,
                                          cache_dtype=_F32, device="cpu"))
    try:
        want = [r.output_tokens for r in incr.generate(prompts, cfg)]
    finally:
        incr.close()
    assert outs["cuda"] == outs["cpu"] == want


@pytest.mark.parametrize("role", ["moe_verifier", "moe_draft"])
def test_moe_spec_horizon_replayed_equals_uncaptured(cuda, role):
    """A tiny dense-MoE model (bf16, INT8 group 32) as the verifier or as
    the draft: three replayed greedy iterations give the uncaptured ones'
    outputs and both caches bitwise; the ragged form captures nothing."""
    moe, dense = ModelSpec(**_TINY_MOE), ModelSpec(**_DRAFT)
    mp, dp = _tiny_params(moe, 0, _BF16, 8, cuda), _tiny_params(dense, 3, _BF16, None, cuda)
    pair = (moe, mp, dense, dp) if role == "moe_verifier" else (
        ModelSpec(**_TINY), _tiny_params(ModelSpec(**_TINY), 2, _BF16, 4, cuda), moe, mp)
    eng = SpecEngine(*pair, beam_width=3, beam_depth=4, max_requests_per_batch=4,
                     max_seq_len=256, cache_dtype=_BF16, device=cuda)
    prompts = [[5, 17, 3, 99, 42], list(range(1, 70)), [7] * 12, [200, 3]]
    lens = eng._h([len(p) for p in prompts])
    roots = eng._h(eng.prefill_both_batch(prompts, [0, 1, 2, 3]))
    caches = [*eng.llm_cache, *eng.ssm_cache]
    saved = [c.clone() for c in caches]
    want = [x.clone() for x in eng.greedy_horizon_async(lens, roots, 3, None, replay=False)]
    want_caches = [c.clone() for c in caches]
    _restore(caches, saved)
    got = eng.greedy_horizon_async(lens, roots, 3, None, replay=True)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(c, w) for c, w in zip(caches, want_caches))
    ragged = ModelSpec(**{**_TINY_MOE, "moe": MoESpec(num_experts=4, top_k=2, impl="ragged")})
    pair = (ragged, mp, dense, dp) if role == "moe_verifier" else (pair[0], pair[1], ragged, mp)
    assert SpecEngine(*pair, beam_width=3, beam_depth=4, max_requests_per_batch=4,
                      max_seq_len=256, cache_dtype=_BF16, device=cuda).graphs is None


def test_router_rows_on_card_do_not_depend_on_the_row_count(cuda):
    """On the card a row's router logits are the same bits in a decode
    step's 8 rows, a verify's 104 and a prefill's 8192."""
    from flexflow_tpu_torch.ops import moe as t_moe

    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((8192, 4096), generator=g, device=cuda).to(_BF16)
    router = torch.randn((4096, 8), generator=g, device=cuda)
    full = t_moe.router_logits(x, router)
    for rows in (slice(0, 8), slice(40, 144), slice(5000, 5008)):
        assert torch.equal(t_moe.router_logits(x[rows], router), full[rows])


@pytest.mark.parametrize("norm", ["rms_norm", "layer_norm"])
def test_norm_rows_on_card_do_not_depend_on_the_row_count(cuda, norm):
    """On the card a row's f32 mean and its norm are the same bits in a
    decode step's 8 rows, a verify's 8 x 13 and a prefill's 8 x 1024,
    wherever the row sits: every one of 8192 rows, called in each size."""
    from flexflow_tpu_torch.ops import norms as t_norms

    g = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn((8192, 4096), generator=g, device=cuda) * 3).to(_BF16)
    sc = torch.randn(4096, generator=g, device=cuda).to(_BF16)
    args = (sc, 1e-5) if norm == "rms_norm" else (sc, torch.zeros(4096, device=cuda), 1e-5)
    fn = getattr(t_norms, norm)
    full = fn(x.reshape(8, 1024, 4096), *args).reshape(8192, 4096)
    mean = t_norms.row_mean(x.float().reshape(8, 1024, 4096)).reshape(8192, 1)
    for rows, shape in ((8, (8, 1, 4096)), (104, (8, 13, 4096))):
        parts = x[:8192 // rows * rows].split(rows)
        got = torch.cat([fn(p.reshape(shape), *args).reshape(rows, 4096) for p in parts])
        assert torch.equal(got, full[:got.shape[0]])
        got = torch.cat([t_norms.row_mean(p.float().reshape(shape)).reshape(rows, 1)
                         for p in parts])
        assert torch.equal(got, mean[:got.shape[0]])


# ---------------------------------------------------------------------------
# CPU offload: the layer store's staged slots on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_staged_quant_slot_equals_resident_layer(cuda, bits):
    """Layer 1 of a pinned [3, ...] carrier staged into a one-layer device
    slot (``LayerStore``) gives, through ``LayerQuant(slot, 0)``, the bits of
    the resident carrier at layer 1, in every regime (m = 1, 8, 104, 8192)."""
    from flexflow_tpu_torch.ops.kernels.quant_matmul import LayerQuant

    gen = torch.Generator(device=cuda).manual_seed(12)
    d, f = 512, 384
    resident = quantize(torch.randn((3, d, f), generator=gen, device=cuda) * 0.05, bits, 128,
                        batch_dims=1, compute_dtype=_BF16)
    store = LayerStore({"w": resident}, 3, cuda)
    assert store.host["w"].q.is_pinned() and store.host["w"].q.device.type == "cpu"
    store.release(0)
    staged = store.acquire(1)["w"]
    assert isinstance(staged, LayerQuant) and staged.layer == 0
    for m in (1, 8, 104, 8192):
        x = torch.randn((m, d), generator=gen, device=cuda).to(_BF16)
        got = t_qm.quant_matmul(x, staged.qa, layer=0)
        assert torch.equal(got, t_qm.quant_matmul(x, resident, layer=1)), m
    store.release(1)


def test_offload_engine_pins_one_copy_of_the_stack(cuda):
    """A ``host_layers`` build and the offload engine built on it hold the
    layer stack page-locked once (the store's leaves, the build's fused
    ones); freeing the engine gives it all back."""
    from flexflow_tpu_torch.models import layer_store

    spec = ModelSpec(**_TINY)
    gc.collect()
    before = layer_store.pinned_bytes
    params = t_params.init_quantized_params(spec, 0, bits=8, group_size=32, dtype=_BF16,
                                            device=cuda, host_layers=True)
    eng = InferenceEngine(spec, params, max_requests_per_batch=2, max_seq_len=64,
                          cache_dtype=_BF16, device=cuda, offload=True)
    del params
    gc.collect()
    store = eng.params["layers"]
    assert layer_store.pinned_bytes - before == store.layer_bytes * spec.num_layers
    del eng, store
    gc.collect()
    assert layer_store.pinned_bytes == before


@pytest.mark.parametrize("moe", [False, True], ids=["llama-int8", "mixtral-bf16"])
def test_offload_ring_across_forwards_gives_resident_bits(cuda, moe):
    """Three greedy decode horizons (the copy ring runs on from one forward
    into the next) and a batched prefill on an offload engine give the
    resident engine's tokens and cache bitwise; each engine's layers come
    from one host build (``init_quantized_params(host_layers=True)``), so
    the values are the same."""
    spec = ModelSpec(**(_TINY_MOE if moe else _TINY))
    params = t_params.init_quantized_params(spec, 0, bits=None if moe else 8, group_size=32,
                                            dtype=_BF16, device=cuda, host_layers=True)
    assert all(t.is_pinned() for t in
               (v.q if isinstance(v, QuantizedArray) else v for v in params["layers"].values()))
    out = []
    for offload in (False, True):
        eng = InferenceEngine(spec, params, max_requests_per_batch=4, max_seq_len=160,
                              cache_dtype=_BF16, device=cuda, offload=offload)
        assert (eng.graphs is None) == offload
        greedy = SamplingConfig(temperature=np.zeros(2, np.float32),
                                top_p=np.ones(2, np.float32), top_k=np.zeros(2, np.int32))
        first = eng.prefill_batch_to_slots_async([[5, 6, 7], [9] * 40], [0, 2], 0, greedy)
        _fill_cache(eng.cache, 1)
        toks = [eng.greedy_horizon_async([60, 63, 130, 5], [3, 17, 101, 250], 4, replay=False)
                for _ in range(3)]
        torch.cuda.synchronize()
        out.append((first, toks, [c.clone() for c in eng.cache]))
        del eng
    (f0, t0, c0), (f1, t1, c1) = out
    assert torch.equal(f0, f1)
    assert all(torch.equal(a, b) for a, b in zip(t0, t1))
    assert all(torch.equal(a, b) for a, b in zip(c0, c1))


def test_ffmodel_defaults_to_cuda(cuda):
    """``FFModel()`` with no device builds on the GPU, and its parameters live there."""
    from flexflow_tpu_torch.ffmodel import FFModel

    ff = FFModel()
    ff.dense(ff.create_tensor((2, 8)), 4)
    ff.compile()
    assert ff.device.type == "cuda"
    assert all(p.is_cuda for d in ff.params.values() for p in d.values())


def test_alexnet_shaped_forward_on_card_matches_cpu(cuda):
    """An AlexNet-shaped graph (11x11 stride-4 conv, 3/2 max pools, 5x5 and
    3x3 convs, dense, dropout) at 3 x 64 x 64: the card's forward within 1e-4
    of the output's magnitude of the CPU's on the card's parameters (f32,
    TF32 off)."""
    from flexflow_tpu_torch.ffmodel import FFModel

    def build(device):
        ff = FFModel(seed=0, device=device)
        t = ff.create_tensor((4, 3, 64, 64))
        t = ff.conv2d(t, 16, 11, 11, 4, 4, 2, 2, activation="relu")
        t = ff.pool2d(t, 3, 3, 2, 2)
        t = ff.conv2d(t, 32, 5, 5, 1, 1, 2, 2, activation="relu")
        t = ff.pool2d(t, 3, 3, 2, 2)
        for c in (48, 32, 32):
            t = ff.conv2d(t, c, 3, 3, 1, 1, 1, 1, activation="relu")
        t = ff.flat(t)
        t = ff.dense(t, 64, activation="relu")
        t = ff.dropout(t, 0.5)
        ff.dense(t, 10)
        ff.compile()
        return ff

    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu, cpu = build(cuda), build("cpu")
        cpu.load_numpy({k: {n: v.detach().cpu().numpy() for n, v in d.items()}
                        for k, d in gpu.params.items()})
        x = np.random.RandomState(0).randn(4, 3, 64, 64).astype(np.float32)
        got, want = gpu.forward(x), cpu.forward(x)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_serving_layout_search_measures_on_the_card(cuda):
    """``optimize_serving_layout`` on one CUDA device times a real decode
    step (its sampling values on the host, as a manager passes them): the
    one candidate runs, no error in the report."""
    from flexflow_tpu_torch.parallel import auto as t_auto

    spec = ModelSpec(arch="LlamaForCausalLM", vocab_size=256, hidden_size=128, num_layers=2,
                     num_heads=4, num_kv_heads=4, head_dim=32, intermediate_size=256,
                     max_position_embeddings=256)
    params = t_params.init_params(spec, 0, torch.bfloat16, cuda)
    best, report = t_auto.optimize_serving_layout(spec, params, batch_size=4, max_seq_len=64,
                                                  n_devices=1, device=cuda,
                                                  log_fn=lambda s: None)
    assert best == t_auto.Layout(1, 1, 1) and "error" not in report[0], report
    assert 0 < report[0]["measured_s"] < float("inf")
