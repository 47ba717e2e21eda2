"""Server-side per-frame semantic mapping pipeline (paper Fig. 2 + Sec. 3.1).

Port of ``repro.core.pipeline`` — the production SemanticXR path only
(``mode="semanticxr"``): per keyframe, the host-side detector stand-in
(``_detect``, numpy) picks the detections, the padded instance masks go to
the device once, and ``ingest_frame`` runs embed -> fused lift / compact /
downsample / stats (``kernels.ops.lift_compact``: the hand-written kernel
on the GPU) -> associate -> prune on the store, in place.  The B and B+P
ablation arms and the staged ``instrument=True`` timings are not ported
yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import association as assoc
from repro_torch.core import depth as depth_mod
from repro_torch.core.knobs import Knobs
from repro_torch.core.store import ObjectStore, store_from_knobs
from repro_torch.data.scenes import Frame
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import ops
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


@dataclass
class MappingServer:
    knobs: Knobs
    embedder: OracleEmbedder
    mode: str = "semanticxr"
    device: str | torch.device = "cuda"
    store: ObjectStore = None
    frame_count: int = 0
    deferred: int = 0

    def __post_init__(self):
        if self.mode != "semanticxr":
            raise NotImplementedError(
                f"mode={self.mode!r}: only the fused 'semanticxr' path is "
                "ported; the B / B+P ablation arms are not")
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
        tensor (D = max_detections_per_frame) or a ``torch.Generator``."""
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
            return times

        t0 = time.perf_counter()
        depth_lo = np.ascontiguousarray(
            depth_mod.downsample_depth(frame.depth, r), np.float32)
        pad_m = np.zeros((D,) + masks_lo.shape[1:], bool)
        pad_m[:nd] = masks_lo
        to = lambda a: torch.from_numpy(a).to(dev)             # noqa: E731
        self.store = ingest_frame(
            self.store, self.embedder, kn, to(depth_lo), to(pad_m),
            to(np.asarray(frame.intrinsics, np.float32)),
            to(np.asarray(frame.pose, np.float32)),
            to(np.pad(cids_np, (0, D - nd))), to(np.arange(D) < nd),
            noise, self.frame_count)
        synchronize(dev)
        times.ingest_ms = (time.perf_counter() - t0) * 1e3
        self.frame_count += 1
        return times
