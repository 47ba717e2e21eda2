"""Seeded open-loop load generator for the serving loop (VOXAR-style).

Port of ``repro.serving.loadgen``: the schedule is drawn in numpy from the
seed, in the reference's order, so it is the reference's schedule; the
query embeddings and poses are f32 tensors on the generator's device.

The production XR workload is not one request at a time: every client
streams poses at ~60 FPS while queries arrive in bursts (a user looks
around, then asks three things in a second).  This module pre-draws that
workload from a seed so a benchmark can replay the IDENTICAL stream
against two serving-loop variants and compare results byte-for-byte:

- **Pose streams** — every client orbits its anchor (same parametric
  track as ``sim.scenario.PoseTrack``) and re-reports its pose every
  ``pose_every`` ticks (60 FPS when tick_s = 1/60).
- **Query arrivals** — per-client Markov-modulated Poisson process: a
  client sits in a ``base_hz`` state and flips (seeded) into a
  ``burst_hz`` state for ``burst_ticks`` at a time.  Arrival counts are
  drawn per tick, so the schedule is OPEN LOOP: arrivals do not wait for
  service, and when a burst exceeds the loop's per-tick service capacity
  the backlog — and therefore the p99 wait — is visible instead of being
  absorbed by a closed feedback loop.
- **Query content** — unit-norm embeddings plus a near-(pose, radius)
  spatial predicate; every spec shares one plan structure so the
  BatchScheduler fuses each scheduler batch into a single dispatch.

Latency accounting rides ``repro_torch.obs``: the loop calls
``note_submit`` / ``note_served`` / ``note_resolved`` with wall timestamps
and the generator folds them into registry histograms
(``serving_query_wait_ms``, ``serving_query_e2e_ms``) plus raw sample lists
for exact p50/p95/p99.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.query import Query
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as obs_metrics


@dataclass(frozen=True)
class LoadSpec:
    """Seeded workload shape (everything the schedule derives from)."""
    n_clients: int = 256
    n_ticks: int = 240
    tick_s: float = 1.0 / 60.0     # serving tick = one frame at 60 FPS
    pose_hz: float = 60.0          # per-client pose report rate
    base_hz: float = 0.5           # per-client steady query rate
    burst_hz: float = 8.0          # in-burst query rate
    burst_prob: float = 0.01       # per-tick P(enter burst | steady)
    burst_ticks: int = 12          # burst dwell time
    k: int = 5
    radius: float = 8.0            # near-predicate radius around the pose
    room: float = 16.0             # pose anchors span [-room/2, room/2]
    seed: int = 0


@dataclass
class LoadGenerator:
    """Pre-drawn open-loop arrival schedule + latency bookkeeping."""
    spec: LoadSpec
    embed_dim: int
    device: str | torch.device = "cuda"
    # derived (built in __post_init__)
    arrivals: list = field(default_factory=list)   # [T] -> [(cid, Query)]
    n_arrivals: int = 0
    _anchor: np.ndarray = None                     # [C, 3]
    _t_submit: dict = field(default_factory=dict)  # rid -> wall
    _t_served: dict = field(default_factory=dict)  # rid -> wall
    wait_ms: list = field(default_factory=list)    # submit -> batch claim
    e2e_ms: list = field(default_factory=list)     # submit -> resolved

    def __post_init__(self):
        self.device = resolve_device(self.device)
        dev = self.device
        sp = self.spec
        radius = torch.tensor(sp.radius, dtype=torch.float32, device=dev)
        rng = np.random.default_rng(sp.seed)
        C, T = sp.n_clients, sp.n_ticks
        half = sp.room / 2
        self._anchor = np.stack([
            rng.uniform(-half * 0.8, half * 0.8, size=C),
            np.full(C, 1.5), rng.uniform(-half * 0.8, half * 0.8, size=C),
        ], axis=1).astype(np.float32)
        self._phase = rng.uniform(0, 2 * np.pi, size=C)
        # MMPP state walk, vectorized over clients: burst_left[c] > 0 means
        # client c draws at burst_hz this tick
        burst_left = np.zeros(C, np.int32)
        self.arrivals = []
        for t in range(T):
            enter = (burst_left == 0) & (rng.random(C) < sp.burst_prob)
            burst_left = np.where(enter, sp.burst_ticks, burst_left)
            rate = np.where(burst_left > 0, sp.burst_hz, sp.base_hz)
            burst_left = np.maximum(burst_left - 1, 0)
            counts = rng.poisson(rate * sp.tick_s)
            tick_arrivals = []
            for c in np.nonzero(counts)[0]:
                for _ in range(int(counts[c])):
                    e = rng.normal(size=self.embed_dim).astype(np.float32)
                    e /= np.linalg.norm(e)
                    pose = self.pose_at(int(c), t)
                    tick_arrivals.append((int(c), Query(
                        embed=torch.from_numpy(e).to(dev),
                        near=(torch.from_numpy(pose).to(dev), radius),
                        k=sp.k)))
            self.arrivals.append(tick_arrivals)
        self.n_arrivals = sum(len(a) for a in self.arrivals)
        self.pose_every = max(1, round(1.0 / (sp.pose_hz * sp.tick_s)))

    # -- workload queries ---------------------------------------------------
    def pose_at(self, c: int, tick: int) -> np.ndarray:
        ang = 0.15 * tick * self.spec.tick_s * 60.0 + self._phase[c]
        return (self._anchor[c] + np.array(
            [0.8 * np.cos(ang), 0.0, 0.8 * np.sin(ang)],
            np.float32)).astype(np.float32)

    def poses(self, tick: int) -> np.ndarray | None:
        """[C, 3] pose reports for this tick, or None off the pose cadence."""
        if tick % self.pose_every:
            return None
        t = 0.15 * tick * self.spec.tick_s * 60.0
        ang = t + self._phase
        off = np.stack([0.8 * np.cos(ang), np.zeros_like(ang),
                        0.8 * np.sin(ang)], axis=1).astype(np.float32)
        return self._anchor + off

    # -- latency accounting (wall clock; called by the serving loop) --------
    def note_submit(self, rid: int, wall: float) -> None:
        self._t_submit[rid] = wall

    def note_served(self, rid: int, wall: float) -> None:
        """Request claimed into a scheduler batch (service start)."""
        if rid in self._t_submit and rid not in self._t_served:
            self._t_served[rid] = wall
            self.wait_ms.append((wall - self._t_submit[rid]) * 1e3)

    def note_resolved(self, rid: int, wall: float) -> None:
        """Result materialized (post-fence) — end-to-end latency."""
        if rid in self._t_submit:
            self.e2e_ms.append((wall - self._t_submit.pop(rid)) * 1e3)
            self._t_served.pop(rid, None)

    def record(self, label: str) -> dict:
        """Fold samples into obs histograms + return exact percentiles."""
        reg = obs_metrics.get_registry()
        if reg is not None:
            hw = reg.histogram("serving_query_wait_ms",
                               "submit -> batch-claim wait under load")
            he = reg.histogram("serving_query_e2e_ms",
                               "submit -> resolved query latency under load")
            for v in self.wait_ms:
                hw.observe(v, mode=label)
            for v in self.e2e_ms:
                he.observe(v, mode=label)
        return {
            "wait_ms": obs_metrics.exact_percentiles(self.wait_ms),
            "e2e_ms": obs_metrics.exact_percentiles(self.e2e_ms),
            "n_arrivals": self.n_arrivals,
        }
