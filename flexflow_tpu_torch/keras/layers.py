"""Keras layer classes lowering onto the FFModel DSL (port of
``flexflow_tpu/keras/layers.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


class Layer:
    """Base: a layer is a callable on symbolic KTensors at build time."""

    def build(self, ff, x):
        raise NotImplementedError

    def __call__(self, x):
        # functional API: defer; x is a KTensor carrying the model-under-build
        from flexflow_tpu_torch.keras.models import KTensor

        if not isinstance(x, (KTensor, list, tuple)):
            raise TypeError(f"a layer takes a KTensor or a list of them, got {type(x).__name__}")
        if isinstance(x, (list, tuple)):
            builder = x[0].builder
            sym = self.build(builder.ff, [t.sym for t in x])
        else:
            builder = x.builder
            sym = self.build(builder.ff, x.sym)
        return KTensor(builder, sym)


@dataclasses.dataclass
class Input:
    shape: Tuple[int, ...]  # without batch dim
    batch_size: int = 32
    dtype: object = torch.float32


class Dense(Layer):
    def __init__(self, units: int, activation: Optional[str] = None,
                 use_bias: bool = True, name: str = "",
                 kernel_regularizer=None, kernel_initializer=None):
        self.units, self.activation, self.use_bias = units, activation, use_bias
        self.name = name
        self.kernel_regularizer = kernel_regularizer
        self.kernel_initializer = kernel_initializer

    def build(self, ff, x):
        t = ff.dense(x, self.units, activation=self.activation,
                     use_bias=self.use_bias, name=self.name)
        _register_kernel_opts(ff, self)
        return t


def _register_kernel_opts(ff, layer):
    """Attach the layer's kernel regularizer/initializer to the node the
    DSL just created (keras kernel_regularizer / kernel_initializer)."""
    node_name = ff._nodes[-1].name
    reg = getattr(layer, "kernel_regularizer", None)
    if reg is not None:
        from flexflow_tpu_torch.keras import regularizers as reg_lib

        reg = reg_lib.get(reg)
        ff.set_regularizer(node_name, l1=reg.l1, l2=reg.l2)
    init = getattr(layer, "kernel_initializer", None)
    if init is not None:
        from flexflow_tpu_torch.keras import initializers as init_lib

        if isinstance(init, str):
            init = {
                "zeros": init_lib.Zeros(),
                "glorot_uniform": init_lib.GlorotUniform(),
                "random_uniform": init_lib.RandomUniform(),
                "random_normal": init_lib.RandomNormal(),
            }[init]
        ff.set_initializer(node_name, init)


class Conv2D(Layer):
    """NCHW (channels_first), as FlexFlow's keras frontend."""

    def __init__(self, filters: int, kernel_size, strides=1, padding="valid",
                 activation: Optional[str] = None, groups: int = 1,
                 use_bias: bool = True, name: str = "",
                 kernel_regularizer=None, kernel_initializer=None):
        self.filters = filters
        self.kernel = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.activation = activation
        self.groups = groups
        self.use_bias = use_bias
        self.name = name
        self.kernel_regularizer = kernel_regularizer
        self.kernel_initializer = kernel_initializer

    def build(self, ff, x):
        if self.padding == "same":
            ph, pw = self.kernel[0] // 2, self.kernel[1] // 2
        elif self.padding == "valid":
            ph = pw = 0
        else:
            ph, pw = _pair(self.padding)
        t = ff.conv2d(x, self.filters, self.kernel[0], self.kernel[1],
                         self.strides[0], self.strides[1], ph, pw,
                         activation=self.activation, groups=self.groups,
                         use_bias=self.use_bias, name=self.name)
        _register_kernel_opts(ff, self)
        return t


class Conv2DTranspose(Layer):
    """NCHW transposed convolution (keras.layers.Conv2DTranspose)."""

    def __init__(self, filters: int, kernel_size, strides=1, padding="valid",
                 output_padding=0, activation: Optional[str] = None,
                 use_bias: bool = True, name: str = ""):
        self.filters = filters
        self.kernel = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.output_padding = _pair(output_padding)
        self.activation = activation
        self.use_bias = use_bias
        self.name = name

    def build(self, ff, x):
        if self.padding == "same":
            ph, pw = self.kernel[0] // 2, self.kernel[1] // 2
        elif self.padding == "valid":
            ph = pw = 0
        else:
            ph, pw = _pair(self.padding)
        return ff.conv2d_transpose(
            x, self.filters, self.kernel[0], self.kernel[1],
            self.strides[0], self.strides[1], ph, pw,
            self.output_padding[0], self.output_padding[1],
            activation=self.activation, use_bias=self.use_bias,
            name=self.name)


class LayerNormalization(Layer):
    def __init__(self, epsilon: float = 1e-3, center: bool = True,
                 scale: bool = True, name: str = ""):
        self.epsilon, self.center, self.scale_ = epsilon, center, scale
        self.name = name

    def build(self, ff, x):
        return ff.layer_norm(x, elementwise_affine=self.scale_,
                             eps=self.epsilon, use_bias=self.center,
                             name=self.name)


class GroupNormalization(Layer):
    """keras.layers.GroupNormalization (channels_first)."""

    def __init__(self, groups: int = 32, epsilon: float = 1e-3,
                 name: str = ""):
        self.groups, self.epsilon, self.name = groups, epsilon, name

    def build(self, ff, x):
        return ff.group_norm(x, self.groups, eps=self.epsilon, name=self.name)


class _Pool2D(Layer):
    kind = "max"

    def __init__(self, pool_size=2, strides=None, padding="valid", name: str = ""):
        self.pool = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool
        self.padding = padding
        self.name = name

    def build(self, ff, x):
        if self.padding == "same":
            ph, pw = self.pool[0] // 2, self.pool[1] // 2
        else:
            ph = pw = 0
        return ff.pool2d(x, self.pool[0], self.pool[1], self.strides[0],
                         self.strides[1], ph, pw, pool_type=self.kind,
                         name=self.name)


class MaxPooling2D(_Pool2D):
    kind = "max"


class AveragePooling2D(_Pool2D):
    kind = "avg"


class Flatten(Layer):
    def __init__(self, name: str = ""):
        self.name = name

    def build(self, ff, x):
        return ff.flat(x, name=self.name)


class Activation(Layer):
    def __init__(self, activation: str, name: str = ""):
        self.activation = activation
        self.name = name

    def build(self, ff, x):
        if self.activation == "softmax":
            return ff.softmax(x)
        return getattr(ff, self.activation)(x)


class Dropout(Layer):
    def __init__(self, rate: float, name: str = ""):
        self.rate = rate
        self.name = name

    def build(self, ff, x):
        return ff.dropout(x, self.rate, name=self.name)


class BatchNormalization(Layer):
    def __init__(self, momentum: float = 0.9, epsilon: float = 1e-5,
                 relu: bool = False, name: str = ""):
        self.momentum, self.eps, self.relu = momentum, epsilon, relu
        self.name = name

    def build(self, ff, x):
        return ff.batch_norm(x, relu=self.relu, momentum=self.momentum,
                             eps=self.eps, name=self.name)


class Embedding(Layer):
    def __init__(self, input_dim: int, output_dim: int, aggr: str = "none",
                 name: str = ""):
        self.input_dim, self.output_dim, self.aggr = input_dim, output_dim, aggr
        self.name = name

    def build(self, ff, x):
        return ff.embedding(x, self.input_dim, self.output_dim, aggr=self.aggr,
                            name=self.name)


class Concatenate(Layer):
    def __init__(self, axis: int = 1, name: str = ""):
        self.axis = axis
        self.name = name

    def build(self, ff, xs):
        return ff.concat(list(xs), axis=self.axis, name=self.name)


class Add(Layer):
    def __init__(self, name: str = ""):
        self.name = name

    def build(self, ff, xs):
        a, b = xs
        return ff.add(a, b)


class _BinaryMerge(Layer):
    """Two-input elementwise merge (Subtract/Multiply/Maximum/Minimum)."""

    _op = ""

    def __init__(self, name: str = ""):
        self.name = name

    def build(self, ff, xs):
        a, b = xs
        return getattr(ff, self._op)(a, b)


class Subtract(_BinaryMerge):
    _op = "subtract"


class Multiply(_BinaryMerge):
    _op = "multiply"


class Maximum(_BinaryMerge):
    _op = "max"


class Minimum(_BinaryMerge):
    _op = "min"


class Reshape(Layer):
    """keras.layers.Reshape: target_shape excludes the batch dim."""

    def __init__(self, target_shape: Sequence[int], name: str = ""):
        self.target_shape = tuple(int(d) for d in target_shape)
        self.name = name

    def build(self, ff, x):
        return ff.reshape(x, (x.shape[0],) + self.target_shape,
                          name=self.name)


class Permute(Layer):
    """keras.layers.Permute: ``dims`` are 1-indexed over the non-batch axes."""

    def __init__(self, dims: Sequence[int], name: str = ""):
        self.dims = tuple(int(d) for d in dims)
        self.name = name

    def build(self, ff, x):
        perm = (0,) + tuple(d for d in self.dims)  # batch stays in front
        return ff.transpose(x, perm, name=self.name)
