"""The port's model importers against the JAX package's on the CPU (f32).

- ``torch_frontend``: the modules of ``tests/test_torch_frontend.py`` and
  ``tests/test_frontend_widening.py`` go through both frontends: the same
  graph (ops, names, attrs, shapes), the port's output within the JAX
  test's tolerance of the ``nn.Module``'s and within 1e-5 of the
  magnitude of JAX's; an imported model trains as JAX's does.
- ``torch_ir``: the tests of ``tests/test_torch_ir.py`` on the port, the
  exported lines string-equal to JAX's, and a port export read by JAX
  (and the reverse) giving the same graph.
- ``onnx_frontend``: the tests of ``tests/test_onnx_frontend.py`` on the
  port, against numpy and JAX; the port's and JAX's ``onnx_proto`` encoders
  give the same bytes for the same ``ModelProto``, and each decodes the
  other's.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as F

from flexflow_tpu import onnx_frontend as j_onnx
from flexflow_tpu import torch_frontend as j_fx
from flexflow_tpu import torch_ir as j_ir
from flexflow_tpu.ffmodel import AdamOptimizer as JAdam
from flexflow_tpu.ffmodel.model import FFModel as JFF
from flexflow_tpu.utils import onnx_proto as jop
from flexflow_tpu_torch import onnx_frontend as t_onnx
from flexflow_tpu_torch import torch_frontend as t_fx
from flexflow_tpu_torch import torch_ir as t_ir
from flexflow_tpu_torch.ffmodel import AdamOptimizer
from flexflow_tpu_torch.ffmodel.model import FFModel
from flexflow_tpu_torch.utils import onnx_proto as op

torch.set_num_threads(2)


def _sig(nodes):
    def attr(v):
        if isinstance(v, np.ndarray):
            return (v.dtype.kind, v.shape, v.tolist())
        if isinstance(v, torch.dtype) or isinstance(v, type) or hasattr(v, "dtype"):
            return np.dtype(str(v).replace("torch.", "")).name if not hasattr(v, "name") \
                else getattr(v, "name", str(v))
        if isinstance(v, (tuple, list)):
            return tuple(attr(x) for x in v)
        return v
    return [(n.op, n.name, [(t.node, t.index) for t in n.inputs],
             {k: attr(v) for k, v in sorted(n.attrs.items()) if k != "dtype"},
             [tuple(s) for s in n.out_shapes]) for n in nodes]


def _close(got, want, rel=1e-5):
    """Within ``rel`` of the finite entries' magnitude; the same non-finite
    entries (a division by a clipped 0 gives inf in both packages)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    got, want = got[fin], want[fin]
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


# --- torch.fx modules ---------------------------------------------------------

class _MLP(tnn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(16, 32)
        self.fc2 = tnn.Linear(32, 4)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class _CNN(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(1, 8, 3, padding=1)
        self.bn = tnn.BatchNorm2d(8)
        self.pool = tnn.MaxPool2d(2)
        self.conv2 = tnn.Conv2d(8, 4, 3, padding=1)
        self.fc = tnn.Linear(4 * 4 * 4, 3)

    def forward(self, x):
        x = self.pool(F.relu(self.bn(self.conv1(x))))
        return self.fc(torch.flatten(self.conv2(x), 1))


def _cnn_with_bn():
    m = _CNN()
    with torch.no_grad():
        m.bn.running_mean.add_(0.3)
        m.bn.running_var.mul_(1.7)
    return m


class _Res(tnn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(8, 8)
        self.fc2 = tnn.Linear(8, 8)

    def forward(self, x):
        h = torch.relu(self.fc1(x))
        h = h + x
        h = self.fc2(h) * 2.0
        return h.reshape(-1, 8)


class _Widened(tnn.Module):
    def forward(self, x):
        a = torch.rsqrt(x.pow(2.0).mean(dim=-1, keepdim=True) + 1.0)
        b = (x * a).contiguous()
        c = b.unsqueeze(1).squeeze(1)
        lo, hi = c.split(4, dim=-1)
        d = torch.cat([lo.softmax(dim=-1), hi.sigmoid()], dim=-1)
        return (d + torch.sqrt(torch.tensor(4.0))).float()


class _Round3(tnn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = tnn.Conv1d(4, 6, 3, stride=2, padding=1)
        self.prelu = tnn.PReLU(num_parameters=6, init=0.1)
        self.sp = tnn.Softplus()
        self.mish = tnn.Mish()

    def forward(self, x):
        return self.mish(self.sp(self.prelu(self.c1(x))))


def _round3():
    m = _Round3()
    with torch.no_grad():
        m.prelu.weight.mul_(torch.arange(1, 7) * 0.3)
    return m


class _PadUpGlu(tnn.Module):
    def __init__(self):
        super().__init__()
        self.pad = tnn.ZeroPad2d((1, 2, 0, 1))
        self.up = tnn.Upsample(scale_factor=2, mode="nearest")
        self.conv = tnn.Conv2d(2, 4, 3)

    def forward(self, x):
        return F.glu(self.conv(self.up(self.pad(x))), dim=1)


class _LinLnEmb(tnn.Module):
    def __init__(self):
        super().__init__()
        self.w = tnn.Parameter(torch.randn(6, 8))
        self.b = tnn.Parameter(torch.randn(6))
        self.g = tnn.Parameter(torch.randn(6))
        self.emb = tnn.Parameter(torch.randn(16, 6))

    def forward(self, x, ids):
        h = F.linear(x, self.w, self.b)
        h = F.layer_norm(h, (6,), weight=self.g)
        return h + F.embedding(ids, self.emb)


class _Methods(tnn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("mask", (torch.arange(6) % 2 == 0))

    def forward(self, x):
        a = x.abs().amax(dim=-1, keepdim=True)
        b = a.expand(-1, 4, 6)
        c = x.masked_fill(self.mask, -1.5)
        d = torch.maximum(b, c).flatten(1)
        e = x.unsqueeze(1).repeat(1, 2, 1, 1)
        return d.sum(dim=-1, keepdim=True) + e.flatten(1).sum(dim=-1, keepdim=True)


class _MaskedNegInf(tnn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("mask", (torch.arange(6) % 2 == 0))

    def forward(self, x):
        return F.softmax(x.masked_fill(self.mask, float("-inf")), dim=-1)


class _PreluChannel(tnn.Module):
    def __init__(self):
        super().__init__()
        self.w = tnn.Parameter(torch.arange(1, 4).float() * 0.1)

    def forward(self, x):
        return F.prelu(x, self.w)


class _ExpandInt(tnn.Module):
    def forward(self, x):
        idx = x.argmax(dim=-1, keepdim=True)
        return idx.expand(-1, 4, 6).float().sum(dim=-1)


class _UpsampleSize(tnn.Module):
    def __init__(self):
        super().__init__()
        self.up = tnn.Upsample(size=(8, 12), mode="nearest")

    def forward(self, x):
        return self.up(x)


class _DeconvGn(tnn.Module):
    def __init__(self):
        super().__init__()
        self.deconv = tnn.ConvTranspose2d(3, 6, 3, stride=2, padding=1)
        self.gn = tnn.GroupNorm(3, 6)
        self.act = tnn.ReLU()

    def forward(self, x):
        return self.act(self.gn(self.deconv(x)))


class _MHA(tnn.Module):
    def __init__(self):
        super().__init__()
        self.attn = tnn.MultiheadAttention(16, 4, bias=False, batch_first=True)

    def forward(self, x):
        out, _ = self.attn(x, x, x)
        return out


class _BasicBlock(tnn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(cout)
        self.relu = tnn.ReLU()
        self.conv2 = tnn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(cout)
        self.down = (tnn.Sequential(tnn.Conv2d(cin, cout, 1, stride, bias=False),
                                    tnn.BatchNorm2d(cout))
                     if stride != 1 or cin != cout else None)

    def forward(self, x):
        idn = x if self.down is None else self.down(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + idn)


class _MiniResNet(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 8, 3, 1, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(8)
        self.relu = tnn.ReLU()
        self.maxpool = tnn.MaxPool2d(2, 2)
        self.layer1 = _BasicBlock(8, 8)
        self.layer2 = _BasicBlock(8, 16, stride=2)
        self.avgpool = tnn.AdaptiveAvgPool2d((1, 1))
        self.fc = tnn.Linear(16, 10)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer2(self.layer1(x))
        x = self.avgpool(x)
        x = x.view(x.size(0), -1)
        return self.fc(x)


class _SE(tnn.Module):
    def __init__(self, c):
        super().__init__()
        self.pool = tnn.AdaptiveAvgPool2d(1)
        self.fc1 = tnn.Conv2d(c, c // 2, 1)
        self.act = tnn.ReLU()
        self.fc2 = tnn.Conv2d(c // 2, c, 1)
        self.gate = tnn.Hardsigmoid()

    def forward(self, x):
        return x * self.gate(self.fc2(self.act(self.fc1(self.pool(x)))))


class _InvertedResidual(tnn.Module):
    def __init__(self):
        super().__init__()
        self.expand = tnn.Conv2d(8, 16, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(16)
        self.hs1 = tnn.Hardswish()
        self.dw = tnn.Conv2d(16, 16, 3, 1, 1, groups=16, bias=False)
        self.bn2 = tnn.BatchNorm2d(16)
        self.se = _SE(16)
        self.project = tnn.Conv2d(16, 8, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(8)

    def forward(self, x):
        h = self.hs1(self.bn1(self.expand(x)))
        h = self.se(self.bn2(self.dw(h)))
        return x + self.bn3(self.project(h))


class _GetitemArith(tnn.Module):
    def forward(self, x):
        a, b = x.chunk(2, dim=1)
        c = a[:, :4] + b[:, 4:]
        d = torch.stack([c, c.mul(2.0)], dim=1)
        e = d.sum(dim=1).clamp(min=-1.0, max=1.0)
        e = torch.nn.functional.silu(e)
        f = e.view(e.size(0), -1)
        return -f


class _FunctionalPools(tnn.Module):
    def forward(self, x):
        a = torch.nn.functional.max_pool2d(x, 2)
        b = torch.nn.functional.avg_pool2d(x, 2)
        return torch.nn.functional.adaptive_avg_pool2d(torch.cat([a, b], dim=1), 1)


# name: (module factory, input shapes, batch, tolerance against the module
# as the JAX tests set it, int32 inputs (shape index -> high))
FX_MODULES = {
    "mlp": (_MLP, [(16,)], 4, 1e-4, {}),
    "cnn_with_bn": (_cnn_with_bn, [(1, 8, 8)], 4, 1e-4, {}),
    "residual_and_methods": (_Res, [(8,)], 4, 1e-4, {}),
    "widened_ops": (_Widened, [(8,)], 3, 2e-5, {}),
    "round3_module_breadth": (_round3, [(4, 10)], 4, 1e-4, {}),
    "pad_upsample_glu": (_PadUpGlu, [(2, 5, 5)], 4, 1e-4, {}),
    "functional_linear_layernorm_embedding": (_LinLnEmb, [(4, 8), (4,)], 3, 2e-4, {1: 16}),
    "tensor_method_breadth": (_Methods, [(4, 6)], 4, 1e-4, {}),
    "masked_fill_neg_inf": (_MaskedNegInf, [(4, 6)], 4, 1e-4, {}),
    "functional_prelu_channel": (_PreluChannel, [(3, 5, 6)], 4, 1e-4, {}),
    "expand_int_dtype": (_ExpandInt, [(4, 6)], 4, 1e-4, {}),
    "upsample_size": (_UpsampleSize, [(2, 4, 6)], 4, 1e-4, {}),
    "conv_transpose_groupnorm": (_DeconvGn, [(3, 8, 8)], 2, 2e-4, {}),
    "multihead_attention": (_MHA, [(5, 16)], 2, 2e-4, {}),
    "resnet_style": (_MiniResNet, [(3, 16, 16)], 2, 2e-4, {}),
    "mobilenet_style": (_InvertedResidual, [(8, 8, 8)], 2, 2e-4, {}),
    "tensor_methods_getitem_arithmetic": (_GetitemArith, [(16, 8)], 2, 2e-4, {}),
    "functional_pools": (_FunctionalPools, [(4, 8, 8)], 2, 2e-4, {}),
}


@pytest.mark.parametrize("name", sorted(FX_MODULES))
def test_fx_module_matches_module_and_jax(name):
    factory, shapes, batch, atol, ints = FX_MODULES[name]
    torch.manual_seed(0)
    module = factory().eval()
    dtypes = [np.int32 if i in ints else np.float32 for i in range(len(shapes))]
    rng = np.random.RandomState(0)
    xs = [rng.randint(0, ints[i], (batch, *s)).astype(np.int32) if i in ints
          else rng.randn(batch, *s).astype(np.float32) for i, s in enumerate(shapes)]
    jf = j_fx.from_torch_module(module, shapes, batch_size=batch, input_dtypes=dtypes)
    tf = t_fx.from_torch_module(module, shapes, batch_size=batch, input_dtypes=dtypes,
                                device="cpu")
    assert _sig(tf._nodes) == _sig(jf._nodes)
    for ff, apply in ((jf, j_fx.apply_torch_weights), (tf, t_fx.apply_torch_weights)):
        ff.compile(optimizer=None)
        apply(ff)
    with torch.no_grad():
        want = module(*[torch.tensor(x) for x in xs])
    got = tf.forward(xs)
    np.testing.assert_allclose(got, want.numpy(), atol=atol, rtol=1e-4)
    _close(got, jf.forward(xs))


def test_imported_model_trains_as_jax():
    torch.manual_seed(0)
    rng = np.random.RandomState(0)
    w = rng.randn(16, 4)
    x = rng.randn(256, 16).astype(np.float32)
    y = (x @ w).argmax(-1).astype(np.int32)
    module = _MLP()
    jf = j_fx.from_torch_module(module, [(16,)], batch_size=32)
    tf = t_fx.from_torch_module(module, [(16,)], batch_size=32, device="cpu")
    jf.compile(optimizer=JAdam(lr=1e-2))
    tf.compile(optimizer=AdamOptimizer(lr=1e-2))
    j_fx.apply_torch_weights(jf)
    t_fx.apply_torch_weights(tf)
    hj = jf.fit(x, y, batch_size=32, epochs=10)
    ht = tf.fit(x, y, batch_size=32, epochs=10)
    assert abs(ht[0]["loss"] - hj[0]["loss"]) <= 1e-4 * hj[0]["loss"]
    assert ht[-1]["accuracy"] > 0.85


def test_fx_refusals():
    class Grouped(tnn.Module):
        def __init__(self):
            super().__init__()
            self.c = tnn.ConvTranspose2d(4, 4, 3, groups=2)

        def forward(self, x):
            return self.c(x)

    class Biased(tnn.Module):
        def __init__(self):
            super().__init__()
            self.attn = tnn.MultiheadAttention(8, 2, batch_first=True)
            with torch.no_grad():
                self.attn.in_proj_bias.fill_(0.5)

        def forward(self, x):
            return self.attn(x, x, x)[0]

    with pytest.raises(NotImplementedError, match="grouped deconv"):
        t_fx.from_torch_module(Grouped(), [(4, 5, 5)], device="cpu")
    with pytest.raises(NotImplementedError, match="bias-free"):
        t_fx.from_torch_module(Biased(), [(3, 8)], device="cpu")


# --- torch_ir -----------------------------------------------------------------

def _cnn_graph(ff):
    x = ff.create_tensor((4, 3, 16, 16))
    t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, activation="relu", name="c1")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, pool_type="max", name="p1")
    t = ff.flat(t, name="fl")
    t = ff.dense(t, 32, activation="relu", name="d1")
    t = ff.dropout(t, rate=0.25, name="dr")
    t = ff.dense(t, 10, name="d2")
    ff.softmax(t)
    return ff


def test_ir_round_trip_numeric_identity(tmp_path):
    ff = _cnn_graph(FFModel(seed=7, device="cpu"))
    jff = _cnn_graph(JFF(seed=7))
    assert t_ir.model_to_string(ff) == j_ir.model_to_string(jff)
    path = str(tmp_path / "model.ff")
    t_ir.model_to_file(ff, path)
    ff2 = FFModel(seed=7, device="cpu")
    outs = t_ir.file_to_ff(path, ff2, [ff2.create_tensor((4, 3, 16, 16))])
    assert len(outs) == 1
    jff2 = JFF(seed=7)
    j_ir.file_to_ff(path, jff2, [jff2.create_tensor((4, 3, 16, 16))])  # JAX reads the port's file
    assert _sig(ff2._nodes) == _sig(jff2._nodes) == _sig(ff._nodes)
    ff.compile()
    ff2.compile()
    x = np.random.RandomState(0).standard_normal((4, 3, 16, 16)).astype(np.float32)
    a, b = ff.forward([x]), ff2.forward([x])
    assert a.shape == b.shape == (4, 10)
    np.testing.assert_array_equal(a, b)  # same seed + same graph = identical
    jff2.compile()
    ff2.load_numpy(jax.tree.map(np.asarray, jff2.params))
    _close(ff2.forward([x]), jff2.forward([x]))


def test_ir_reference_field_orders_load():
    lines = [
        "input_1; ; conv1,; INPUT",
        "conv1; input_1,; pool1,; CONV2D; 6; 5; 5; 1; 1; 0; 0; 10; 1; 1",
        "relu1; conv1,; pool1,; RELU",
        "pool1; relu1,; flat1,; POOL2D; 2; 2; 0; 30; 10",
        "flat1; pool1,; linear1,; FLAT",
        "linear1; flat1,; output,; LINEAR; 10; 11; 1",
        "output; linear1,; ; OUTPUT",
    ]
    ff, jff = FFModel(device="cpu"), JFF()
    assert len(t_ir.string_to_ff(lines, ff, [ff.create_tensor((2, 3, 14, 14))])) == 1
    j_ir.string_to_ff(lines, jff, [jff.create_tensor((2, 3, 14, 14))])
    assert _sig(ff._nodes) == _sig(jff._nodes)
    ff.compile()
    out = ff.forward([np.zeros((2, 3, 14, 14), np.float32)])
    assert out.shape == (2, 10)


def test_ir_softmax_axis_round_trips():
    ff = FFModel(device="cpu")
    ff.softmax(ff.create_tensor((2, 4, 6)), axis=1)
    ff2 = FFModel(device="cpu")
    t_ir.string_to_ff(t_ir.model_to_string(ff), ff2, [ff2.create_tensor((2, 4, 6))])
    assert next(n for n in ff2._nodes if n.op == "softmax").attrs["axis"] == 1


def test_ir_unknown_op_raises():
    with pytest.raises(NotImplementedError):
        t_ir.string_to_ff(["n; a,; ; FROBNICATE"], FFModel(device="cpu"), [])
    ff = FFModel(device="cpu")
    ff.reshape(ff.create_tensor((2, 6)), (3, 4))
    with pytest.raises(NotImplementedError):
        t_ir.model_to_string(ff)


def test_ir_torch_module_exports(tmp_path):
    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = tnn.Linear(12, 24)
            self.fc2 = tnn.Linear(24, 5)

        def forward(self, x):
            return self.fc2(torch.relu(self.fc1(x)))

    path, jpath = str(tmp_path / "net.ff"), str(tmp_path / "jnet.ff")
    t_ir.torch_to_file(Net(), (12,), path)
    j_ir.torch_to_file(Net(), (12,), jpath)
    text = open(path).read()
    assert "LINEAR" in text and "RELU" in text and "INPUT" in text
    assert text == open(jpath).read()
    ff = FFModel(device="cpu")
    assert len(t_ir.file_to_ff(path, ff, [ff.create_tensor((8, 12))])) == 1
    ff.compile()
    assert ff.forward([np.ones((8, 12), np.float32)]).shape == (8, 5)


# --- ONNX ---------------------------------------------------------------------

def _mk_model(m, nodes, inputs, outputs, inits):
    graph = m.GraphProto(node=nodes, name="g",
                         initializer=[m.array_to_tensor(a, name=n) for n, a in inits.items()],
                         input=inputs, output=outputs)
    return m.ModelProto(ir_version=8, graph=graph, opset_import=[m.OperatorSetIdProto(version=17)])


def _ints(m, name, vals):
    return m.AttributeProto(name=name, ints=list(vals), type=m.AttributeProto.INTS)


def _f(m, name, v):
    return m.AttributeProto(name=name, f=float(v), type=m.AttributeProto.FLOAT)


def _i(m, name, v):
    return m.AttributeProto(name=name, i=int(v), type=m.AttributeProto.INT)


def _mlp(m, rng):
    w1 = rng.randn(16, 32).astype(np.float32)
    b1 = rng.randn(32).astype(np.float32)
    w2 = rng.randn(32, 4).astype(np.float32)
    nodes = [m.NodeProto(op_type="Gemm", input=["x", "w1", "b1"], output=["h"], name="fc1"),
             m.NodeProto(op_type="Relu", input=["h"], output=["hr"]),
             m.NodeProto(op_type="MatMul", input=["hr", "w2"], output=["y"], name="fc2")]
    model = _mk_model(m, nodes, [m.tensor_value_info("x", m.TensorProto.FLOAT, ("N", 16))],
                      [m.tensor_value_info("y", m.TensorProto.FLOAT, ("N", 4))],
                      {"w1": w1, "b1": b1, "w2": w2})
    return model, lambda x: np.maximum(x @ w1 + b1, 0) @ w2


def _cnn(m, rng):
    w = rng.randn(6, 3, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    wf = rng.randn(6 * 3 * 3, 5).astype(np.float32)
    nodes = [
        m.NodeProto(op_type="Conv", input=["x", "w", "b"], output=["c"], name="conv",
                    attribute=[_ints(m, "strides", (1, 1)), _ints(m, "pads", (0, 0, 0, 0)),
                               _ints(m, "kernel_shape", (3, 3))]),
        m.NodeProto(op_type="Relu", input=["c"], output=["cr"]),
        m.NodeProto(op_type="MaxPool", input=["cr"], output=["pool"],
                    attribute=[_ints(m, "kernel_shape", (2, 2)), _ints(m, "strides", (2, 2))]),
        m.NodeProto(op_type="Flatten", input=["pool"], output=["flat"]),
        m.NodeProto(op_type="MatMul", input=["flat", "wf"], output=["y"], name="fc"),
    ]
    model = _mk_model(m, nodes, [m.tensor_value_info("x", m.TensorProto.FLOAT, ("N", 3, 8, 8))],
                      [m.tensor_value_info("y", m.TensorProto.FLOAT, ("N", 5))],
                      {"w": w, "b": b, "wf": wf})

    def want(x):  # conv by im2col in numpy, then relu, 2x2 max pool, dense
        cols = np.stack([x[:, :, i:i + 6, j:j + 6] for i in range(3) for j in range(3)], -1)
        c = np.einsum("nchwk,ock->nohw", cols, w.reshape(6, 3, 9)) + b[None, :, None, None]
        cr = np.maximum(c, 0)
        pool = cr.reshape(x.shape[0], 6, 3, 2, 3, 2).max(axis=(3, 5))
        return pool.reshape(x.shape[0], -1) @ wf
    return model, want


def _gap_ops(m, rng):
    w = rng.randn(32, 16).astype(np.float32)
    b = rng.randn(32).astype(np.float32)
    nodes = [
        m.NodeProto(op_type="Gemm", input=["x", "w", "b"], output=["h"], name="fc",
                    attribute=[_f(m, "alpha", 0.5), _f(m, "beta", 2.0), _i(m, "transB", 1)]),
        m.NodeProto(op_type="Clip", input=["h"], output=["hc"],
                    attribute=[_f(m, "min", 0.0), _f(m, "max", 6.0)]),
        m.NodeProto(op_type="Unsqueeze", input=["hc"], output=["hu"],
                    attribute=[_ints(m, "axes", (1,))]),
        m.NodeProto(op_type="Expand", input=["hu", "tgt"], output=["he"]),
        m.NodeProto(op_type="Split", input=["he"], output=["s1", "s2"],
                    attribute=[_i(m, "axis", 2), _ints(m, "split", (16, 16))]),
        m.NodeProto(op_type="Div", input=["s1", "s2"], output=["d"]),
        m.NodeProto(op_type="ReduceMean", input=["d"], output=["y"],
                    attribute=[_ints(m, "axes", (1,)), _i(m, "keepdims", 0)]),
    ]
    model = _mk_model(m, nodes, [m.tensor_value_info("x", m.TensorProto.FLOAT, ("N", 16))],
                      [m.tensor_value_info("y", m.TensorProto.FLOAT, ("N", 16))],
                      {"w": w, "b": b, "tgt": np.asarray([1, 3, 32], np.int64)})

    def want(x):
        h = np.clip(0.5 * (x @ w.T) + 2.0 * b, 0.0, 6.0)
        he = np.broadcast_to(h[:, None, :], (x.shape[0], 3, 32))
        return (he[:, :, :16] / he[:, :, 16:]).mean(axis=1)
    return model, want


def _pad_gap_cast(m, rng):
    nodes = [
        m.NodeProto(op_type="Pad", input=["x"], output=["xp"],
                    attribute=[_ints(m, "pads", (0, 0, 1, 1, 0, 0, 1, 1))]),
        m.NodeProto(op_type="GlobalAveragePool", input=["xp"], output=["g"]),
        m.NodeProto(op_type="Flatten", input=["g"], output=["f"]),
        m.NodeProto(op_type="Cast", input=["f"], output=["y"],
                    attribute=[_i(m, "to", m.TensorProto.FLOAT)]),
    ]
    model = _mk_model(m, nodes, [m.tensor_value_info("x", m.TensorProto.FLOAT, ("N", 3, 6, 6))],
                      [m.tensor_value_info("y", m.TensorProto.FLOAT, ("N", 3))], {})
    return model, lambda x: np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1))).mean(axis=(2, 3))


def _unsqueeze_constant_clip(m, rng):
    def const(name, v):
        return m.NodeProto(op_type="Constant", input=[], output=[name], attribute=[
            m.AttributeProto(name="value", t=m.array_to_tensor(np.asarray(v, np.float32),
                                                               name=name + "_v"),
                             type=m.AttributeProto.TENSOR)])
    nodes = [
        const("cmin", 0.0), const("cmax", 0.5),
        m.NodeProto(op_type="Clip", input=["x", "cmin", "cmax"], output=["c"]),
        m.NodeProto(op_type="Unsqueeze", input=["c"], output=["u"],
                    attribute=[_ints(m, "axes", (1, 3))]),
        m.NodeProto(op_type="ReduceMean", input=["u"], output=["y"],
                    attribute=[_ints(m, "axes", (1, 3)), _i(m, "keepdims", 0)]),
    ]
    model = _mk_model(m, nodes, [m.tensor_value_info("x", m.TensorProto.FLOAT, ("N", 6))],
                      [m.tensor_value_info("y", m.TensorProto.FLOAT, ("N", 6))], {})
    return model, lambda x: np.clip(x, 0.0, 0.5)


def _gather_negative(m, rng):
    """C4: an embedding ``Gather`` over a [10, 4] initializer with negative
    ids (ONNX allows [-s, s-1]), added to the input."""
    table = rng.randn(10, 4).astype(np.float32)
    ids = np.array([[0, -1, 9], [1, -10, 5]], np.int64)
    nodes = [
        m.NodeProto(op_type="Constant", input=[], output=["ids"], attribute=[
            m.AttributeProto(name="value", t=m.array_to_tensor(ids, name="ids_v"),
                             type=m.AttributeProto.TENSOR)]),
        m.NodeProto(op_type="Gather", input=["table", "ids"], output=["g"],
                    attribute=[_i(m, "axis", 0)]),
        m.NodeProto(op_type="Add", input=["x", "g"], output=["y"]),
    ]
    model = _mk_model(m, nodes, [m.tensor_value_info("x", m.TensorProto.FLOAT, ("N", 3, 4))],
                      [m.tensor_value_info("y", m.TensorProto.FLOAT, ("N", 3, 4))],
                      {"table": table})
    return model, lambda x: x + table[ids]


# name: (model maker, input shape, batch, seed: tests/test_onnx_frontend.py's, the
# input drawn after the weights from the same stream)
ONNX_MODELS = {"mlp": (_mlp, (16,), 4, 1), "cnn": (_cnn, (3, 8, 8), 2, 2),
               "round4_gap_ops": (_gap_ops, (16,), 4, 3),
               "pad_gap_cast": (_pad_gap_cast, (3, 6, 6), 2, 4),
               "multiaxis_unsqueeze_constant_clip": (_unsqueeze_constant_clip, (6,), 3, 5),
               "gather_negative_ids": (_gather_negative, (3, 4), 2, 6)}


@pytest.mark.parametrize("name", sorted(ONNX_MODELS))
def test_onnx_model_matches_numpy_and_jax(tmp_path, name):
    """Each file is written by the port's codec; the port's model runs it
    within 1e-5 of the numpy oracle (1e-4 for the conv, as JAX's test) and of
    JAX's model on the same file."""
    make, shape, batch, seed = ONNX_MODELS[name]
    rng = np.random.RandomState(seed)
    model, want_fn = make(op, rng)
    path = str(tmp_path / f"{name}.onnx")
    op.save(model, path)
    tf = t_onnx.from_onnx_model(path, batch_size=batch, device="cpu")
    jf = j_onnx.from_onnx_model(path, batch_size=batch)
    assert _sig(tf._nodes) == _sig(jf._nodes)
    for ff, apply in ((tf, t_onnx.apply_onnx_weights), (jf, j_onnx.apply_onnx_weights)):
        ff.compile(optimizer=None)
        apply(ff)
    x = rng.randn(batch, *shape).astype(np.float32)
    got = tf.forward(x)
    tol = 1e-4 if name == "cnn" else 1e-5
    np.testing.assert_allclose(got, want_fn(x), rtol=tol, atol=tol)
    _close(got, jf.forward(x))
    if name == "gather_negative_ids":  # a gather and an add: exact in both
        np.testing.assert_array_equal(got, want_fn(x))
        np.testing.assert_array_equal(got, jf.forward(x))


@pytest.mark.parametrize("name", sorted(ONNX_MODELS))
def test_onnx_proto_encoders_give_the_same_bytes(name):
    """The same message built with each package's codec serializes to the
    same bytes, and each codec decodes the other's."""
    make, seed = ONNX_MODELS[name][0], ONNX_MODELS[name][3]
    tmodel, _ = make(op, np.random.RandomState(seed))
    jmodel, _ = make(jop, np.random.RandomState(seed))
    raw = tmodel.serialize()
    assert raw == jmodel.serialize()
    assert op.ModelProto.parse(raw).serialize() == raw
    assert jop.ModelProto.parse(raw).serialize() == op.ModelProto.parse(
        jmodel.serialize()).serialize()


def test_onnx_wire_format_round_trip(tmp_path):
    w = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    m = _mk_model(op, [op.NodeProto(op_type="Relu", input=["x"], output=["y"], name="r")],
                  [op.tensor_value_info("x", op.TensorProto.FLOAT, ("N", 8))],
                  [op.tensor_value_info("y", op.TensorProto.FLOAT, ("N", 8))], {"w": w})
    p = str(tmp_path / "m.onnx")
    op.save(m, p)
    m2 = op.load(p)
    assert m2.graph.node[0].op_type == "Relu" and m2.graph.node[0].input == ["x"]
    np.testing.assert_array_equal(op.tensor_to_array(m2.graph.initializer[0]), w)
    assert m2.graph.input[0].type.tensor_type.shape.dim[1].dim_value == 8
    n = op.NodeProto(op_type="Softmax", input=["x"], output=["y"],
                     attribute=[op.AttributeProto(name="axis", i=-1, type=op.AttributeProto.INT)])
    assert op.NodeProto.parse(n.serialize()).attribute[0].i == -1
    for a in (np.arange(6, dtype=np.int64).reshape(2, 3), np.arange(3, dtype=np.int32),
              np.linspace(0, 1, 4)):
        np.testing.assert_array_equal(op.tensor_to_array(op.array_to_tensor(a)), a)
