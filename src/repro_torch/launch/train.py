"""Training launcher for any registered config of the port (the captioner,
DeepSeek-V3 / V2, the dense GQA configs gemma2-27b, h2o-danube-3-4b, yi-9b
and minitron-4b, phi-3-vision-4.2b, the recurrent jamba-v0.1-52b and
rwkv6-3b, and their smoke cuts), on one device.  It feeds tokens only, as
the reference's trainer does: a vision model's ``vis_proj`` gets a zero
gradient and moves by weight decay alone.  Under a config's ``remat`` each
period is recomputed in the backward pass, and inside it each Mamba scan
chunk too.  A jamba ``--seq`` longer than its scan chunk (32; 16 in the
smoke cut) is best a multiple of it: the reference's Mamba raises at any
other, so only then can the two trainers resume each other's run.

Port of ``repro.launch.train``, with its flags and behaviour.  The
initial parameters are drawn from a generator seeded 0 on the training
device (the card draws a full-width model in well under a second; the
numbers differ from the CPU's, as both differ from JAX's).
Fault tolerance: checkpoints every ``--ckpt-every`` steps (atomic,
manifest'd, in the reference's format, so a run either package started
resumes under the other); on start it resumes from the latest complete
checkpoint, and after a resume the token iterator is reseeded with the
resumed step, as the reference does.  ``--kill-at N`` simulates a node
failure (exit code 42 after step N).  ``--compress-grads`` quantizes the
gradients to int8 with error feedback before the update.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch semanticxr-captioner-110m --steps 200 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v3-671b-smoke --steps 4 --batch 2 --seq 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch gemma2-27b-smoke --steps 4 --batch 2 --seq 40 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi-3-vision-4.2b-smoke --steps 4 --batch 2 --seq 40 \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch jamba-v0.1-52b-smoke --steps 4 --batch 2 --seq 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch rwkv6-3b-smoke --steps 4 --batch 2 --seq 40 --device cpu

It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from repro_torch import convert
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.configs.base import get_config
from repro_torch.data import tokens as tok
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.api import model_api
from repro_torch.optim import adamw


def main(argv=None, *, device=None, on_step=None):
    """Train; returns the final parameters (an ``LM``).  ``device``
    overrides ``--device``; ``on_step(step, metrics, params)``, if given,
    sees every step's metrics (device tensors) and the updated
    parameters."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="semanticxr-captioner-110m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--kill-at", type=int, default=0,
                    help="simulate node failure after this step")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)

    cfg = get_config(args.arch)
    api = model_api(cfg)
    ocfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                             warmup_steps=min(50, args.steps // 4))

    params = api.init(torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    ckpt_dir = Path(args.ckpt_dir) / cfg.name
    start = 0
    last = ckpt_mod.latest_step(ckpt_dir)
    if last is not None:
        print(f"[restore] resuming from step {last}")
        params = convert.lm_params_from_numpy(cfg, ckpt_mod.restore(
            ckpt_dir, last, convert.lm_params_to_tree(params), device=dev),
            device=dev)
        opt = convert.opt_state_from_numpy(cfg, ckpt_mod.restore(
            ckpt_dir / "opt", last, convert.opt_state_to_numpy(
                adamw.init_opt_state(params, ocfg), cfg), device=dev),
            device=dev)
        start = last
    else:
        opt = adamw.init_opt_state(params, ocfg)
    params.requires_grad_(True)
    ef = coll.init_ef(params) if args.compress_grads else None

    it = tok.batch_iterator(args.batch, args.seq, seed=start,
                            vocab_size=cfg.vocab_size)
    t0 = time.perf_counter()
    for step in range(start + 1, args.steps + 1):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        loss, metrics, grads = loss_and_grads(api.loss, params, batch)
        if ef is not None:
            grads, ef = coll.compress_grads_ef(grads, ef)
        params, opt, om = adamw.adamw_update(grads, opt, params, ocfg)
        del grads        # or the next step's backward holds two sets
        m = {"loss": loss, **metrics, **om}
        if on_step is not None:
            on_step(step, m, params)
        if step % args.log_every == 0 or step == args.steps:
            tok_s = args.batch * args.seq * args.log_every / \
                max(time.perf_counter() - t0, 1e-9)
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"ce {float(m['ce']):.4f} gnorm {float(m['grad_norm']):.2f} "
                  f"lr {float(m['lr']):.2e} tok/s {tok_s:.0f}")
            t0 = time.perf_counter()
        if args.ckpt_every and step % args.ckpt_every == 0:
            ckpt_mod.save(ckpt_dir, step, convert.lm_params_to_tree(params))
            ckpt_mod.save(ckpt_dir / "opt", step,
                          convert.opt_state_to_numpy(opt, cfg))
        if args.kill_at and step == args.kill_at:
            print(f"[fault-injection] simulated node failure at step {step}")
            raise SystemExit(42)
    print("training complete")
    return params


if __name__ == "__main__":
    main()
