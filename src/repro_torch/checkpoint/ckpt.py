"""Atomic, manifest'd checkpoints that interchange with ``repro``'s.

Port of ``repro.checkpoint.ckpt``, same files and format:
``<dir>/step_<N>/arrays.npz`` holds one array per leaf, named by its path
with ``/`` written as ``|``; ``manifest.json`` lists each leaf's name,
shape and dtype; bf16 is stored as its uint16 bits.  A tree is nested
dicts (keys in sorted order, as JAX flattens them), lists and tuples (by
index) and NamedTuples (by field name), with torch tensors or numpy arrays
as leaves; given the reference's pytree layout
(``convert.lm_params_to_tree`` / ``convert.opt_state_to_numpy``), the
port writes the names and bits ``repro`` writes and reads what it wrote.

Durability: a checkpoint is written into a temp dir, fsynced, then renamed
into place, and ``latest_step`` is replaced atomically after the rename,
so it only ever names a complete checkpoint; a crash mid-write leaves a
``.tmp_step_*`` dir that nothing reads.  ``restore(..., device=)`` puts
the logical tensors on any device, and ``restore(..., shardings=)`` on the
device of each leaf's ``NamedSharding``'s mesh: the port's counterpart of
the reference's elastic restore onto another mesh, for a one-device
mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.device import resolve_device


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=()):
    """(name, leaf) in JAX's flattening order; None is an empty subtree."""
    if tree is None:
        return
    if _is_namedtuple(tree):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), prefix + (f,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _flatten(t, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _unflatten(tree, values: dict, prefix=()):
    """``tree``'s structure with each leaf replaced by ``values[name]``."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), values, prefix + (f,))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, values, prefix + (str(i),))
                          for i, t in enumerate(tree))
    return values["/".join(prefix)]


def _host(leaf):
    """(numpy array, dtype name): bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        host = t.numpy()
    else:
        host = np.asarray(leaf)
    return host, str(host.dtype)


def _fsync(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str | Path, step: int, tree, *, keep: int = 3) -> Path:
    """Write ``tree`` as ``<ckpt_dir>/step_<step>``; keep the newest
    ``keep`` checkpoints.  Returns the checkpoint's directory."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = {}
    manifest = {"step": step, "time": time.time(), "leaves": []}
    for name, leaf in _flatten(tree):
        host, dtype_name = _host(leaf)
        arrays[name.replace("/", "|")] = host
        manifest["leaves"].append({"name": name, "shape": list(host.shape),
                                   "dtype": dtype_name})
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    for f in ("arrays.npz", "manifest.json"):
        _fsync(tmp / f)
    _fsync(tmp)
    final = ckpt_dir / f"step_{step}"
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    latest = ckpt_dir / f".latest_step_{os.getpid()}"
    latest.write_text(str(step))
    _fsync(latest)
    os.replace(latest, ckpt_dir / "latest_step")
    _fsync(ckpt_dir)
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*"))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    p = Path(ckpt_dir) / "latest_step"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def _sharding_device(sharding) -> torch.device:
    """The one device of a ``NamedSharding``'s mesh; a mesh of more devices
    (or a planning mesh, which has none) raises: the port places a whole
    tensor, it does not split one."""
    mesh = sharding.mesh
    if getattr(mesh, "devices", None) is None or mesh.size != 1:
        raise ValueError(f"restore places leaves on a one-device mesh, not "
                         f"on {dict(mesh.shape)}")
    return resolve_device(mesh.devices.flat[0])


def restore(ckpt_dir: str | Path, step: int, like, *, device="cuda",
            shardings=None):
    """``like``: a tree of tensors or numpy arrays giving the structure,
    shapes and dtypes.  Returns the same structure of tensors on
    ``device``, each in its ``like`` leaf's dtype.  ``shardings``, a tree
    like ``like`` of ``distributed.sharding.NamedSharding``s, puts each
    leaf on its sharding's mesh device instead (``device`` unread)."""
    d = Path(ckpt_dir) / f"step_{step}"
    if shardings is None:
        dev = resolve_device(device)
        devs = None
    else:
        devs = {name: _sharding_device(s) for name, s in _flatten(shardings)}
    manifest = json.loads((d / "manifest.json").read_text())
    dtypes = {leaf["name"]: leaf["dtype"] for leaf in manifest["leaves"]}
    values = {}
    with np.load(d / "arrays.npz") as data:
        for name, leaf in _flatten(like):
            host = data[name.replace("/", "|")]
            if tuple(host.shape) != tuple(leaf.shape):
                raise ValueError(f"{name}: checkpoint {host.shape} vs model "
                                 f"{tuple(leaf.shape)}")
            if dtypes.get(name) == "bfloat16":
                t = torch.from_numpy(host.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(host))
            if isinstance(leaf, torch.Tensor):
                want = leaf.dtype
            else:       # the torch dtype of the numpy leaf's dtype
                want = torch.from_numpy(np.zeros(0, np.asarray(leaf).dtype)
                                        ).dtype
            values[name] = t.to(device=dev if devs is None else devs[name],
                                dtype=want)
    return _unflatten(like, values)
