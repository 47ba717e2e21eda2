"""Object-level depth-mapping co-design (paper Sec. 3.3, Tab. 5).

Port of ``repro.core.depth``.  Upstream, the device decimates depth by
``depth_downsampling_ratio`` per spatial dim before transmission.
Detections whose projected bbox area (full-res units) falls below
``min_mapping_bbox_area`` are deferred until a closer observation gives
reliable depth.  The detector stand-in runs on the host, so these helpers
work on numpy arrays (and on tensors, where slicing and comparison apply).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import geometry as geo
from repro_torch.core.knobs import Knobs


def downsample_depth(depth, ratio: int):
    """Stride-decimate a [H, W] depth frame by ``ratio`` per dim."""
    if ratio <= 1:
        return depth
    return depth[::ratio, ::ratio]


def downsample_mask(mask, ratio: int):
    """Stride-decimate a [H, W] instance mask by ``ratio`` per dim."""
    if ratio <= 1:
        return mask
    return mask[::ratio, ::ratio]


# The min_mapping_bbox_area knob default is expressed in the paper's
# full-sensor (720p) pixel units; bbox areas measured at a simulated render
# resolution are rescaled to these units before gating.
REF_SENSOR_PIXELS = 720 * 1280


def mapping_gate(area, knobs: Knobs, *, frame_pixels: int):
    """True if this observation is incorporated now; False = deferred.

    ``area`` is the detection's projected bbox pixel area in the frame's own
    full-res units (scalar or [K] array), ``frame_pixels`` the frame's H*W.
    Area is rescaled to full-sensor (720p) units so the knob default applies
    at any render resolution; the gate only bites when depth is actually
    downsampled (ratio > 1).
    """
    scaled = area * (REF_SENSOR_PIXELS / frame_pixels)
    keep = scaled >= knobs.min_mapping_bbox_area
    return keep | (knobs.depth_downsampling_ratio <= 1)


def mapping_gate_mask(mask_full: torch.Tensor, knobs: Knobs):
    """Gate straight from a [H, W] bool instance mask tensor (area via
    ``geometry.bbox_pixel_area``)."""
    return mapping_gate(geo.bbox_pixel_area(mask_full), knobs,
                        frame_pixels=mask_full.numel())


@dataclass(frozen=True)
class UpstreamRates:
    """Per-frame upstream payload (bytes) under the co-design."""
    rgb_bytes: float
    depth_bytes: float
    pose_bytes: float = 12 * 4        # 3x4 pose matrix fp32

    @property
    def total(self) -> float:
        return self.rgb_bytes + self.depth_bytes + self.pose_bytes


# Calibration constants (the reference's, documented in EXPERIMENTS.md):
# only keyframes stream RGB to the server, and 16-bit depth packs
# losslessly at ~0.3x.
RGB_KEYFRAME_MBPS = 1.2
DEPTH_PACK = 0.3


def upstream_bytes_per_frame(h: int, w: int, knobs: Knobs, *,
                             fps: float = 30.0) -> UpstreamRates:
    r = knobs.depth_downsampling_ratio
    depth_px = (h // r) * (w // r) if r > 1 else h * w
    return UpstreamRates(rgb_bytes=RGB_KEYFRAME_MBPS * 1e6 / 8 / fps,
                         depth_bytes=2.0 * depth_px * DEPTH_PACK)


def upstream_mbps(h: int, w: int, knobs: Knobs, *, fps: float = 30.0,
                  keyframe_interval: int = 5) -> float:
    """Average upstream rate in Mbps (RGB keyframe share + depth + pose at
    the keyframe rate)."""
    rates = upstream_bytes_per_frame(h, w, knobs, fps=fps)
    per_sec = RGB_KEYFRAME_MBPS * 1e6 / 8 + \
        (rates.depth_bytes + rates.pose_bytes) * fps / keyframe_interval
    return per_sec * 8 / 1e6
