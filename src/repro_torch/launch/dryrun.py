"""Dry run: plan every (arch x shape) cell on the production mesh.

Port of ``repro.launch.dryrun``.  Each cell's train, prefill or decode step
is built on the planning mesh (``launch.mesh.make_planning_mesh``: the
production mesh's axes, no devices) with the reference's per-kind config
rewrites, and one JSON a cell records what the plan fixes: the per-device
argument, output and alias bytes of the step, reckoned exactly from the
shard shapes its shardings give; the analytic FLOPs and memory traffic of
``launch.costs``; and the roofline bound without its collective term.  No
tensor of a cell is allocated (deepseek-v3-671b has 671 B parameters), no
device is touched and no environment variable is set.

What the reference reads from XLA's compiled program has no counterpart
in an eager PyTorch program, and is recorded as null with the reason
(``not_reckoned``): the temporary and peak bytes of a compiler's buffer
plan, XLA's own cost analysis, and the collective schedule (so the
roofline leaves the collective term out).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import ASSIGNED
from repro_torch.configs.base import SHAPES, cell_is_runnable, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import costs as costs_mod
from repro_torch.launch.mesh import make_planning_mesh
from repro_torch.launch.steps import build_step, bytes_per_device

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

NOT_RECKONED = {
    "temp_bytes_per_dev": "an eager PyTorch step has no compiler buffer "
                          "plan to read temporaries from",
    "peak_bytes_per_dev": "needs the temporaries (no compiler buffer plan)",
    "hlo_cost_raw": "an eager PyTorch step compiles no XLA program to cost",
    "collectives": "an eager PyTorch step has no compiled collective "
                   "schedule to read",
    "roofline.collective_s": "left out: no collective schedule",
}


def _alias_bytes(step, args) -> int:
    """Bytes a device holds of donated argument leaves whose output, at the
    same place in the step's outputs, has their shape, dtype and sharding:
    what the reference's donation lets XLA reuse."""
    total = 0
    for a, o in step.donated:
        outs = dict(sh.leaves(step.out[o]))
        for path, s in sh.leaves(args[a]):
            t = outs.get(path)
            if t is not None and (t.shape, t.dtype, t.sharding.spec) == (
                    s.shape, s.dtype, s.sharding.spec):
                total += s.bytes_per_device
    return total


def cell_config(arch: str, shape: str, mesh, *, absorb_mla: bool = False,
                prune_tiles: bool = False, seq_parallel: bool = False,
                grad_accum: int = 1, int8_kv: bool = False):
    """``arch``'s config as the dry run plans it at ``shape`` on ``mesh``:
    the reference's per-kind rewrites and the run's flags."""
    cfg = get_config(arch)
    cell = SHAPES[shape]
    # MoE dispatch groups track the data-parallel world so token groups stay
    # shard-local.
    dp = 1
    for a, n in mesh.shape.items():
        if a != "model":
            dp *= n
    if cfg.moe is not None:
        cfg = cfg.replace(moe_groups=min(dp, cell.global_batch),
                          moe_weight_shard="2d" if cell.kind == "train"
                          else "ep")
    if cfg.rwkv is not None and cell.kind != "train":
        cfg = cfg.replace(rwkv_tm_shard="replicated")
    if int8_kv and cell.kind == "decode":
        cfg = cfg.replace(kv_cache_dtype="int8")
    if absorb_mla and cfg.mla is not None:
        cfg = cfg.replace(name=cfg.name + "+absorb",
                          mla=dataclasses.replace(cfg.mla, absorb=True))
    if prune_tiles:
        cfg = cfg.replace(prune_tiles=True)
    if seq_parallel and cell.kind == "train" and cell.seq_len % 16 == 0:
        cfg = cfg.replace(act_shard=(sh.dp_axes(mesh), "model"))
    if grad_accum > 1 and cell.kind == "train":
        cfg = cfg.replace(grad_accum=grad_accum)
    if cell.kind != "train":
        cfg = cfg.replace(remat=False)
    return cfg


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             absorb_mla: bool = False, prune_tiles: bool = False,
             seq_parallel: bool = False, grad_accum: int = 1,
             int8_kv: bool = False, verbose: bool = True) -> dict:
    mesh = make_planning_mesh(multi_pod=multi_pod)
    chips = mesh.size
    cell = SHAPES[shape]
    cfg = cell_config(arch, shape, mesh, absorb_mla=absorb_mla,
                      prune_tiles=prune_tiles, seq_parallel=seq_parallel,
                      grad_accum=grad_accum, int8_kv=int8_kv)

    rec = {"arch": arch, "shape": shape, "kind": cell.kind,
           "mesh": dict(mesh.shape), "chips": chips,
           "multi_pod": multi_pod, "mla_absorb": bool(absorb_mla and cfg.mla),
           "prune_tiles": prune_tiles, "seq_parallel": seq_parallel,
           "grad_accum": grad_accum, "int8_kv": int8_kv}
    t0 = time.perf_counter()
    step, args = build_step(cfg, mesh, cell)
    arg_b = sum(bytes_per_device(a) for a in args)
    out_b = sum(bytes_per_device(o) for o in step.out)
    alias_b = _alias_bytes(step, args)
    t1 = time.perf_counter()
    rec["memory"] = {
        "argument_bytes_per_dev": arg_b,
        "output_bytes_per_dev": out_b,
        "temp_bytes_per_dev": None,
        "alias_bytes_per_dev": alias_b,
        "peak_bytes_per_dev": None,
    }
    rec["hlo_cost_raw"] = None
    rec["collectives"] = None

    cc = costs_mod.step_costs(cfg, cell)
    rl = costs_mod.roofline_terms(cc, 0.0, chips=chips)
    del rl["collective_s"]
    rec["analytic"] = {
        "flops": cc.flops, "hbm_bytes": cc.hbm_bytes,
        "model_flops": cc.model_flops, "n_params": cc.n_params,
        "n_active": cc.n_active,
    }
    rec["roofline"] = rl
    rec["timings"] = {"lower_s": None, "compile_s": None, "plan_s": t1 - t0}
    rec["not_reckoned"] = NOT_RECKONED

    if verbose:
        print(f"[{arch} x {shape}] mesh={tuple(mesh.shape.values())} "
              f"args/dev={arg_b / 2**30:.4f}GiB "
              f"out/dev={out_b / 2**30:.4f}GiB "
              f"alias/dev={alias_b / 2**30:.4f}GiB flops={cc.flops:.4e} "
              f"dominant={rl['dominant']} "
              f"bound(no collectives)={rl['bound_s'] * 1e3:.3f}ms")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--absorb-mla", action="store_true")
    ap.add_argument("--prune-tiles", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    outdir = Path(args.out) / ("pod2" if args.multi_pod else "pod1")
    outdir.mkdir(parents=True, exist_ok=True)

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    cells = [(a, s) for a in archs for s in shapes]

    failures = []
    for a, s in cells:
        name = f"{a}__{s}" + ("__absorb" if args.absorb_mla else "") + \
            ("__prune" if args.prune_tiles else "") + \
            ("__sp" if args.seq_parallel else "") + \
            (f"__ga{args.grad_accum}" if args.grad_accum > 1 else "") + \
            ("__int8kv" if args.int8_kv else "")
        path = outdir / f"{name}.json"
        if not cell_is_runnable(a, s):
            rec = {"arch": a, "shape": s, "skipped": True,
                   "reason": "long_500k needs sub-quadratic attention; "
                             "this arch is pure full-attention (DESIGN.md)"}
            path.write_text(json.dumps(rec, indent=1))
            print(f"[{a} x {s}] SKIP (full-attention @ 500k)")
            continue
        try:
            rec = run_cell(a, s, multi_pod=args.multi_pod,
                           absorb_mla=args.absorb_mla,
                           prune_tiles=args.prune_tiles,
                           seq_parallel=args.seq_parallel,
                           grad_accum=args.grad_accum,
                           int8_kv=args.int8_kv)
            path.write_text(json.dumps(rec, indent=1))
        except Exception as e:  # noqa: BLE001 — report and continue
            failures.append((a, s, repr(e)))
            traceback.print_exc()
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("dry-run complete:", len(cells), "cells")


if __name__ == "__main__":
    main()
