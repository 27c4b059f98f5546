"""Interconnect topology model: collective costs over a device mesh (port of
``flexflow_tpu/parallel/topology.py``).

Closed-form ring-collective costs per mesh axis:

- all_reduce:      2 * (k-1)/k * bytes / link_bw   (reduce-scatter + all-gather)
- all_gather:          (k-1)/k * bytes / link_bw
- reduce_scatter:      (k-1)/k * bytes / link_bw
- ppermute (1 hop):            bytes / link_bw

A mesh axis larger than the topology's device count pays ``dcn_bw`` (the
network between hosts) instead. ``assign_axes`` places ``Layout`` axes on
the physical axes, largest first, and ``parallel.auto.analytic_cost`` uses
these costs when a topology is attached to its ``MachineModel``.

The JAX module's defaults are a TPU slice's (per-link rates and the v5e /
v4 presets); they are not the port's. Here ``dims``, ``link_bw`` and
``dcn_bw`` are always given by the caller.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class TorusTopology:
    """A device mesh: per-axis device counts, per-link bytes/s in one
    direction, and the bytes/s between hosts."""

    dims: Tuple[int, ...]
    link_bw: float
    dcn_bw: float
    wraparound: bool = True  # each axis a ring (not a line with two ends)

    @property
    def num_devices(self) -> int:
        return math.prod(self.dims)

    def _ring_bw(self, k: int) -> float:
        """Effective per-device ring bandwidth for a k-device axis: a ring
        over a whole wraparound axis uses both directions of its links; a
        sub-axis ring or a line gets one."""
        if self.wraparound and k in self.dims:
            return 2.0 * self.link_bw
        return self.link_bw

    def fits(self, k: int) -> bool:
        """Can a k-device mesh axis stay on the links (not spill to the
        network between hosts)?"""
        return k <= self.num_devices

    def all_reduce_time(self, nbytes: float, k: int) -> float:
        if k <= 1:
            return 0.0
        bw = self._ring_bw(k) if self.fits(k) else self.dcn_bw
        return 2.0 * (k - 1) / k * nbytes / bw

    def all_gather_time(self, nbytes: float, k: int) -> float:
        """``nbytes`` = the GATHERED (full) buffer size."""
        if k <= 1:
            return 0.0
        bw = self._ring_bw(k) if self.fits(k) else self.dcn_bw
        return (k - 1) / k * nbytes / bw

    reduce_scatter_time = all_gather_time

    def ppermute_time(self, nbytes: float) -> float:
        """One neighbor hop (a pipeline stage boundary)."""
        return nbytes / self.link_bw

    def assign_axes(self, axis_sizes: Dict[str, int]) -> Dict[str, bool]:
        """Greedily place mesh axes on the physical axes.

        Returns {axis_name: stays_on_links}. Axes are placed largest first on
        the remaining capacity; what does not divide it spills to the network
        between hosts.
        """
        capacity = self.num_devices
        placement = {}
        for name, k in sorted(axis_sizes.items(), key=lambda kv: -kv[1]):
            if k <= 1:
                placement[name] = True
                continue
            if capacity % k == 0 and capacity >= k:
                placement[name] = True
                capacity //= k
            else:
                placement[name] = False
        return placement
