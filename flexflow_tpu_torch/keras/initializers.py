"""Keras initializers (port of ``flexflow_tpu/keras/initializers.py``).

Layers accept ``kernel_initializer=``; the FFModel DSL calls it at compile
as ``init(shape, fan_in, fan_out, generator)``. An initializer with a
``seed`` draws from a CPU ``torch.Generator`` seeded by it (JAX: a
``PRNGKey(seed)``), otherwise from the model's generator.
"""

from __future__ import annotations

import math

import torch


def _generator(seed, generator: torch.Generator) -> torch.Generator:
    return generator if seed is None else torch.Generator().manual_seed(seed)


class Initializer:
    def __call__(self, shape, fan_in, fan_out, generator):
        raise NotImplementedError


class DefaultInitializer(Initializer):
    """Layer-type default (glorot for kernels)."""

    def __call__(self, shape, fan_in, fan_out, generator):
        return GlorotUniform()(shape, fan_in, fan_out, generator)


class Zeros(Initializer):
    def __call__(self, shape, fan_in, fan_out, generator):
        return torch.zeros(shape)


def _uniform(shape, lo, hi, gen):
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


class GlorotUniform(Initializer):
    def __init__(self, seed=None):
        self.seed = seed

    def __call__(self, shape, fan_in, fan_out, generator):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(shape, -limit, limit, _generator(self.seed, generator))


class RandomUniform(Initializer):
    def __init__(self, minval=-0.05, maxval=0.05, seed=None):
        self.minval, self.maxval, self.seed = minval, maxval, seed

    def __call__(self, shape, fan_in, fan_out, generator):
        return _uniform(shape, self.minval, self.maxval, _generator(self.seed, generator))


class RandomNormal(Initializer):
    def __init__(self, mean=0.0, stddev=0.05, seed=None):
        self.mean, self.stddev, self.seed = mean, stddev, seed

    def __call__(self, shape, fan_in, fan_out, generator):
        return self.mean + self.stddev * torch.randn(
            shape, generator=_generator(self.seed, generator))
