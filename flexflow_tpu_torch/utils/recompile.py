"""RecompileState: adaptive reconfiguration over static buckets (port of
``flexflow_tpu/utils/recompile.py``).

The reference's RecompileState pairs a ``trigger`` that inspects runtime
state each step with an ``alter`` that changes the model's configuration;
the next step then runs the new configuration.

Under static shapes a "recompile" is a move to another configuration
bucket. In the JAX package the bucket is a jit cache key; in the port it is
the key of a captured step (``serving/graphs.StepGraphs`` keeps one CUDA
graph per static key), so returning to a bucket seen before replays its
graph and only a new bucket pays a capture. ``round_up_bucket`` bounds the
number of buckets, as the prefill and attention-window buckets do
elsewhere. MoE serving needs none of this: ``ops/moe.py`` drops no token
whatever the load.

Usage::

    rs = RecompileState(
        trigger=lambda state: state["overflow_frac"] > 0.1,
        alter=lambda state: state.update(
            capacity_factor=round_up_bucket(state["capacity_factor"] * 1.5)),
    )
    for step in range(n):
        metrics = train_step(capacity_factor=state["capacity_factor"])
        rs.step(state)   # fires trigger/alter; counts reconfigurations
"""

from __future__ import annotations

from typing import Callable


def round_up_bucket(x: float, buckets=(1.0, 1.25, 1.5, 2.0, 3.0, 4.0)) -> float:
    """Snap a capacity factor to the static bucket grid."""
    for b in buckets:
        if x <= b:
            return b
    return buckets[-1]


class RecompileState:
    """A trigger / alter pair evaluated each step."""

    def __init__(self, trigger: Callable[..., bool], alter: Callable[..., None]):
        self.trigger_func = trigger
        self.alter_func = alter
        self.recompilations = 0

    def trigger(self, *args, **kw) -> bool:
        return bool(self.trigger_func(*args, **kw))

    def alter(self, *args, **kw) -> None:
        self.alter_func(*args, **kw)
        self.recompilations += 1

    def step(self, *args, **kw) -> bool:
        """Evaluate the trigger; when it fires, run alter. Returns whether
        the configuration changed (the next step runs another bucket's
        captured step, capturing it first if the bucket is new)."""
        if self.trigger(*args, **kw):
            self.alter(*args, **kw)
            return True
        return False
