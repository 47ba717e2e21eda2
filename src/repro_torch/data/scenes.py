"""Synthetic Replica-like indoor scenes: RGB-D + pose sequences with
ground-truth instances.

A numpy copy of ``repro.data.scenes`` (the port imports nothing of
``repro``), so the same seed renders the same frames in both packages.
N objects (primitive point clouds: boxes / spheres / cylinders, per-class
size priors) are placed in a room and observed by a camera orbiting the
room centre.  Each frame renders depth + instance masks by point-splatting
at pinhole resolution, with exact ground truth.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CLASS_NAMES = [
    "chair", "table", "sofa", "lamp", "book", "cup", "plant", "monitor",
    "keyboard", "door", "window", "cushion", "shelf", "vase", "bottle",
    "clock", "rug", "bin", "picture", "blanket",
]
N_CLASSES = len(CLASS_NAMES)

# per-class (base size m, shape kind)
_CLASS_SIZE = {i: 0.2 + 0.5 * ((i * 2654435761) % 7) / 6 for i in
               range(N_CLASSES)}


@dataclass
class SceneObject:
    oid: int
    class_id: int
    center: np.ndarray          # [3]
    points: np.ndarray          # [P, 3] world


@dataclass
class Scene:
    objects: list
    room_size: float
    rng_seed: int


@dataclass
class Frame:
    idx: int
    depth: np.ndarray           # [H, W] f32 metres (0 = no hit)
    inst: np.ndarray            # [H, W] int32 object id (0 = none)
    pose: np.ndarray            # [4,4] cam->world
    intrinsics: np.ndarray      # [fx, fy, cx, cy]
    visible_ids: np.ndarray     # object ids with enough pixels


def _object_cloud(rng, kind: int, size: float, n: int) -> np.ndarray:
    u = rng.uniform(-1, 1, size=(n, 3))
    if kind == 0:        # box shell
        ax = rng.integers(0, 3, size=n)
        sgn = rng.choice([-1.0, 1.0], size=n)
        u[np.arange(n), ax] = sgn
    elif kind == 1:      # sphere shell
        u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-6)
    else:                # cylinder
        th = rng.uniform(0, 2 * np.pi, size=n)
        u[:, 0], u[:, 2] = np.cos(th), np.sin(th)
    return u * size / 2


def make_scene(n_objects: int = 80, room: float = 8.0, seed: int = 0,
               points_per_object: int = 4096) -> Scene:
    rng = np.random.default_rng(seed)
    objs = []
    for i in range(n_objects):
        cid = int(rng.integers(0, N_CLASSES))
        size = _CLASS_SIZE[cid] * rng.uniform(0.7, 1.3)
        center = np.array([rng.uniform(-room / 2, room / 2),
                           rng.uniform(0.0, 2.0),
                           rng.uniform(-room / 2, room / 2)])
        pts = _object_cloud(rng, cid % 3, size, points_per_object) + center
        objs.append(SceneObject(oid=i + 1, class_id=cid, center=center,
                                points=pts.astype(np.float32)))
    return Scene(objects=objs, room_size=room, rng_seed=seed)


def _look_at(eye, target, up=np.array([0.0, 1.0, 0.0])):
    f = target - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.maximum(np.linalg.norm(r), 1e-9)
    u = np.cross(r, f)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = r, u, f, eye
    return pose


def render_frame(scene: Scene, idx: int, *, h: int = 120, w: int = 160,
                 n_frames: int = 200, min_pixels: int = 12) -> Frame:
    """Point-splat render: nearest point per pixel -> depth + instance."""
    ang = 2 * np.pi * idx / n_frames
    r = scene.room_size * 0.35
    eye = np.array([r * np.cos(ang), 1.5, r * np.sin(ang)])
    pose = _look_at(eye, np.array([0.0, 1.0, 0.0]))
    fx = fy = 0.9 * w
    cx, cy = w / 2, h / 2
    intr = np.array([fx, fy, cx, cy], np.float32)
    return _splat(scene, idx, pose, intr, h, w, min_pixels)


def rerender_frame(scene: Scene, frame: Frame,
                   *, min_pixels: int = 12) -> Frame:
    """Re-render an existing frame's viewpoint against the CURRENT scene:
    same pose / intrinsics / resolution, fresh depth + instance splat.
    This is how a dynamic scene event (spawn / move / remove) becomes
    visible to a mapping frontend that consumes pre-rendered frames — the
    engine re-renders the tick's frame instead of replaying stale pixels.
    Identical to ``render_frame`` when the scene hasn't changed."""
    h, w = frame.depth.shape
    return _splat(scene, frame.idx, frame.pose, frame.intrinsics, h, w,
                  min_pixels)


def _splat(scene: Scene, idx: int, pose: np.ndarray, intr: np.ndarray,
           h: int, w: int, min_pixels: int) -> Frame:
    fx, fy, cx, cy = (float(x) for x in intr)
    depth = np.zeros((h, w), np.float32)
    inst = np.zeros((h, w), np.int32)
    zbuf = np.full((h, w), np.inf, np.float32)
    R, t = pose[:3, :3], pose[:3, 3]
    for obj in scene.objects:
        pc = (obj.points - t) @ R            # world -> cam
        z = pc[:, 2]
        ok = z > 0.05
        if not ok.any():
            continue
        u = (pc[ok, 0] / z[ok]) * fx + cx
        v = (pc[ok, 1] / z[ok]) * fy + cy
        zz = z[ok]
        ui, vi = u.astype(int), v.astype(int)
        inside = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
        ui, vi, zz = ui[inside], vi[inside], zz[inside]
        closer = zz < zbuf[vi, ui]
        vi, ui, zz = vi[closer], ui[closer], zz[closer]
        zbuf[vi, ui] = zz
        depth[vi, ui] = zz
        inst[vi, ui] = obj.oid
    ids, counts = np.unique(inst[inst > 0], return_counts=True)
    visible = ids[counts >= min_pixels]
    return Frame(idx=idx, depth=depth, inst=inst, pose=pose,
                 intrinsics=np.asarray(intr, np.float32),
                 visible_ids=visible.astype(np.int32))


def scene_stream(scene: Scene, n_frames: int = 200, keyframe_interval: int = 5,
                 **kw):
    """Yield keyframes (the paper maps keyframes at interval 5)."""
    for idx in range(0, n_frames, keyframe_interval):
        yield render_frame(scene, idx, n_frames=n_frames, **kw)
