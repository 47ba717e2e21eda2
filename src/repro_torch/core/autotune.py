"""Knob autotuning (paper Sec. 7.4 future work, implemented).

Port of ``repro.core.autotune``.  Given budgets, pick the quality-maximal
knob settings that satisfy them, and adapt the update frequency online
from measured downstream bytes.

* upstream: choose the SMALLEST depth-downsampling ratio whose modeled rate
  fits the budget (smallest ratio = most geometry = best quality).
* downstream: multiplicative-increase/decrease on the update interval,
  driven by the measured bytes of recent update packets.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from repro_torch.core.depth import upstream_mbps
from repro_torch.core.knobs import Knobs


def tune_upstream(knobs: Knobs, *, budget_mbps: float, h: int = 720,
                  w: int = 1280, max_ratio: int = 8) -> Knobs:
    """Quality-first: smallest ratio meeting the budget (monotone search)."""
    for r in range(1, max_ratio + 1):
        cand = dataclasses.replace(knobs, depth_downsampling_ratio=r)
        if upstream_mbps(h, w, cand) <= budget_mbps:
            return cand
    return dataclasses.replace(knobs, depth_downsampling_ratio=max_ratio)


@dataclass
class DownstreamTuner:
    """Adapt local_map_update_frequency to a bytes/second budget."""
    budget_bytes_per_s: float
    tick_rate_hz: float = 6.0          # keyframe rate
    min_interval: int = 1
    max_interval: int = 32
    _ema: float = field(default=0.0)

    def observe(self, knobs: Knobs, packet_bytes: int) -> Knobs:
        interval = knobs.local_map_update_frequency
        rate = packet_bytes * self.tick_rate_hz / max(interval, 1)
        self._ema = 0.5 * self._ema + 0.5 * rate
        if self._ema > self.budget_bytes_per_s and interval < self.max_interval:
            interval *= 2                       # back off: halve frequency
        elif self._ema < 0.4 * self.budget_bytes_per_s and \
                interval > self.min_interval:
            interval = max(interval // 2, self.min_interval)  # recover
        return dataclasses.replace(knobs,
                                   local_map_update_frequency=interval)
