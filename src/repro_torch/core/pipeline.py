"""Server-side per-frame semantic mapping pipeline (paper Fig. 2 + Sec. 3.1).

Port of ``repro.core.pipeline``.  Per keyframe the host-side detector
stand-in (``_detect``, numpy) picks the detections and the padded instance
masks go to the device once.  Three modes, the paper's Fig. 3 arms:

  B        ``mode="baseline"``: one object at a time — ``lift_depth`` at
           ``LIFT_BUFFER`` points and a one-row embedding per detection,
           then padded to D; geometry uncapped into association.
  B+P      ``mode="parallel"``: the same stages over the padded [D, ...]
           detection batch.
  B+P+SD   ``mode="semanticxr"``: the production path, ``ingest_frame``:
           embed -> fused lift / compact / downsample / stats
           (``kernels.ops.lift_compact``: the hand-written kernel on the
           GPU) -> associate -> prune; with ``instrument=True`` the same
           stages one after another, each ending in a synchronize, so
           ``StageTimes`` holds per-stage walls.

The store is written in place in every mode.  Row i of the embedder noise
serves detection i in every arm.  ``enable_index`` attaches a cluster index
(``repro_torch.index``) that every mapped keyframe maintains.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import association as assoc
from repro_torch.core import depth as depth_mod
from repro_torch.core import geometry as geo
from repro_torch.core.knobs import Knobs
from repro_torch.core.store import ObjectStore, store_from_knobs
from repro_torch.data.scenes import Frame
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.perception.embedder import OracleEmbedder

LIFT_BUFFER = 4096   # per-object lift cap (the reference's uncapped buffer)


@dataclass
class StageTimes:
    detect_ms: float = 0.0
    embed_ms: float = 0.0
    lift_ms: float = 0.0
    associate_ms: float = 0.0
    ingest_ms: float = 0.0     # fused path (embed + lift + assoc + prune)

    @property
    def total_ms(self):
        return (self.detect_ms + self.embed_ms + self.lift_ms +
                self.associate_ms + self.ingest_ms)

    def record(self, mode: str) -> None:
        """Feed the per-stage wall times into the process-wide metrics
        registry (``repro_torch.obs``; a no-op when none is installed)."""
        reg = obs_metrics.get_registry()
        if reg is None:
            return
        h = reg.histogram("mapping_stage_ms",
                          "per-keyframe mapping stage wall time (ms)")
        for stage in ("detect", "embed", "lift", "associate", "ingest"):
            v = getattr(self, f"{stage}_ms")
            if v > 0.0:
                h.observe(v, stage=stage, mode=mode)


def ingest_frame(store: ObjectStore, embedder: OracleEmbedder, knobs: Knobs,
                 depth_lo, masks, intr, pose, cids, valid, noise,
                 frame: int) -> ObjectStore:
    """One keyframe from padded masks to the pruned store (in place)."""
    budget = knobs.max_object_points_server
    embs = embedder.embed_observation(cids, noise)
    pts, ns, cent, _, _ = ops.lift_compact(
        depth_lo, masks, intr, pose, stride=knobs.depth_downsampling_ratio,
        budget=budget, lift_cap=LIFT_BUFFER)
    det = assoc.Detections(embed=embs, label=cids, points=pts, n_points=ns,
                           valid=valid)
    store = assoc.associate(store, det, frame=frame, point_budget=budget,
                            det_centroid=cent)
    return assoc.prune_transients(store, frame=frame,
                                  min_obs=knobs.min_obs_before_sync)


MODES = ("baseline", "parallel", "semanticxr")


@dataclass
class MappingServer:
    """``donate`` is accepted for the reference's signature and has no
    effect: the port always writes the store in place."""
    knobs: Knobs
    embedder: OracleEmbedder
    mode: str = "semanticxr"        # "baseline" | "parallel" | "semanticxr"
    instrument: bool = False        # semanticxr: staged walls, not fused
    donate: bool = False
    device: str | torch.device = "cuda"
    store: ObjectStore = None
    frame_count: int = 0
    deferred: int = 0
    cluster_index: object = None    # repro_torch.index.ClusterIndex | None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode={self.mode!r}: one of {MODES}")
        self.device = resolve_device(self.device)
        if self.store is None:
            self.store = store_from_knobs(self.knobs,
                                          self.embedder.embed_dim,
                                          device=self.device)

    # ------------------------------------------------------------------
    def _detect(self, frame: Frame, classes: dict):
        """Detector stand-in: GT instance masks + mapping-policy filters,
        on the host.  One vectorized bbox/area pass over the instance map,
        the deferral decision from ``depth.mapping_gate``.
        Returns (class_ids [nd] int32, masks_lo [nd, H/r, W/r] bool)."""
        kn = self.knobs
        r = kn.depth_downsampling_ratio
        inst_lo = frame.inst[::r, ::r] if r > 1 else frame.inst
        oids = np.asarray(frame.visible_ids, np.int32)
        cids = np.asarray([classes[int(o)] for o in oids], np.int32)
        if oids.size and kn.skip_mapping_set:
            m = ~np.isin(cids, np.asarray(kn.skip_mapping_set))
            oids, cids = oids[m], cids[m]
        if oids.size == 0:
            return cids[:0], np.zeros((0,) + inst_lo.shape, bool)

        # full-res bbox areas in one pass: row/col presence -> extents
        pres = frame.inst[None, :, :] == oids[:, None, None]   # [K, H, W]

        def extent(present):                                   # [K, L] bool
            first = present.argmax(axis=1)
            last = present.shape[1] - 1 - present[:, ::-1].argmax(axis=1)
            return last - first + 1

        area = extent(pres.any(axis=2)) * extent(pres.any(axis=1))
        keep = np.asarray(depth_mod.mapping_gate(
            area, kn, frame_pixels=frame.inst.size))
        self.deferred += int((~keep).sum())
        oids = oids[keep][: kn.max_detections_per_frame]
        cids = cids[keep][: kn.max_detections_per_frame]
        masks_lo = inst_lo[None, :, :] == oids[:, None, None]
        return cids, masks_lo

    # ------------------------------------------------------------------
    def process_frame(self, frame: Frame, classes: dict,
                      noise: torch.Tensor | torch.Generator) -> StageTimes:
        """Map one keyframe; returns per-stage wall times (Fig. 3).
        ``noise`` is the embedder's per-view noise: a [D, E] standard-normal
        tensor (D = max_detections_per_frame; row i serves detection i) or
        a ``torch.Generator`` that one is drawn from."""
        kn = self.knobs
        r = kn.depth_downsampling_ratio
        D = kn.max_detections_per_frame
        dev = self.device
        times = StageTimes()

        t0 = time.perf_counter()
        cids_np, masks_lo = self._detect(frame, classes)
        times.detect_ms = (time.perf_counter() - t0) * 1e3
        nd = len(cids_np)
        if nd == 0:
            self.frame_count += 1
            times.record(self.mode)
            return times

        if isinstance(noise, torch.Generator):
            noise = torch.randn((D, self.embedder.embed_dim), generator=noise,
                                device=noise.device, dtype=torch.float32)
        t0 = time.perf_counter()
        depth_lo = np.ascontiguousarray(
            depth_mod.downsample_depth(frame.depth, r), np.float32)
        pad_m = np.zeros((D,) + masks_lo.shape[1:], bool)
        pad_m[:nd] = masks_lo
        to = lambda a: torch.from_numpy(a).to(dev)             # noqa: E731
        args = (to(depth_lo), to(pad_m),
                to(np.asarray(frame.intrinsics, np.float32)),
                to(np.asarray(frame.pose, np.float32)),
                to(np.pad(cids_np, (0, D - nd))), to(np.arange(D) < nd))
        if self.mode == "semanticxr" and not self.instrument:
            self.store = ingest_frame(self.store, self.embedder, kn, *args,
                                      noise, self.frame_count)
            synchronize(dev)
            times.ingest_ms = (time.perf_counter() - t0) * 1e3
        else:
            self._staged(times, nd, *args, noise)
        self._maintain_index()
        self.frame_count += 1
        times.record(self.mode)
        return times

    def _staged(self, times: StageTimes, nd: int, depth_lo, masks, intr,
                pose, cids, valid, noise) -> None:
        """The B / B+P arms and the instrumented SD arm: embed, lift and
        associate + prune as separate stages, each ending in a synchronize
        and timed into ``times``."""
        kn = self.knobs
        r = kn.depth_downsampling_ratio
        D = kn.max_detections_per_frame
        budget = kn.max_object_points_server
        dev = self.device
        emb = self.embedder
        noise = noise.to(dev, torch.float32)

        t0 = time.perf_counter()
        if self.mode == "baseline":
            embs = torch.cat([emb.embed_observation(cids[i:i + 1],
                                                    noise[i:i + 1])
                              for i in range(nd)])
        else:
            embs = emb.embed_observation(cids, noise)
        synchronize(dev)
        times.embed_ms = (time.perf_counter() - t0) * 1e3

        cent = None
        t0 = time.perf_counter()
        if self.mode == "baseline":
            lifted = [geo.lift_depth(depth_lo, masks[i], intr, pose, stride=r,
                                     max_points=LIFT_BUFFER)
                      for i in range(nd)]
            pts = torch.stack([p for p, _, _ in lifted])
            ns = torch.stack([n for _, n, _ in lifted])
        elif self.mode == "parallel":
            pts, ns, _ = geo.lift_depth(depth_lo, masks, intr, pose,
                                        stride=r, max_points=LIFT_BUFFER)
        else:
            pts, ns, cent, _, _ = ops.lift_compact(
                depth_lo, masks, intr, pose, stride=r, budget=budget,
                lift_cap=LIFT_BUFFER)
        synchronize(dev)
        times.lift_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        if self.mode == "baseline":          # pad the object batch to D
            pad = D - nd
            pts = torch.nn.functional.pad(pts, (0, 0, 0, 0, 0, pad))
            ns = torch.nn.functional.pad(ns, (0, pad))
            embs = torch.nn.functional.pad(embs, (0, 0, 0, pad))
        det = assoc.Detections(embed=embs, label=cids, points=pts,
                               n_points=ns, valid=valid)
        self.store = assoc.associate(self.store, det, frame=self.frame_count,
                                     point_budget=budget, det_centroid=cent)
        self.store = assoc.prune_transients(self.store,
                                            frame=self.frame_count,
                                            min_obs=kn.min_obs_before_sync)
        synchronize(dev)
        times.associate_ms = (time.perf_counter() - t0) * 1e3

    # ------------------------------------------------------------------
    def enable_index(self, **kw) -> None:
        """Attach a cluster-summary index over the mapping store; every
        mapped keyframe then maintains it and ``CloudService.query_spec``
        plans coarse-to-fine through it."""
        from repro_torch.index import ClusterIndex
        self.cluster_index = ClusterIndex.for_target(self.store, **kw)

    def _maintain_index(self) -> None:
        if self.cluster_index is not None:
            self.cluster_index.refresh(self.store)
