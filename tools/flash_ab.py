#!/usr/bin/env python3
"""A/B of the flash-attention kernels (forward and gradient) between two
checkouts, on one GPU.

    python3 tools/flash_ab.py run --src DIR --out FILE
    python3 tools/flash_ab.py compare A B [C ...]

``run`` imports ``repro_torch`` from ``DIR`` (a checkout's ``src``),
builds its kernel, calls ``flash_attention_cuda`` (with and without
``return_lse``) on fixed seeded inputs at the head widths every checkout
since the lse was added takes, (64, 64) and (128, 128): the captioner's
prefill and training shapes, gemma2-27b's prefill (S = 5000, window 4096,
softcap 50), ragged S, window, softcap, non-causal, MQA, bf16 and f32; at
DeepSeek MLA's (192, 128) (``MLA_CASES``) and h2o-danube-3's (120, 120)
(``DH120_CASES``) where the checkout takes them; then
``flash_attention_bwd_cuda`` on the forward's output and lse at the same
two pairs (``GRAD_CASES``: the captioner's training shape, ragged S,
window, softcap, non-causal, G = 1, S = 1024), at (192, 128)
(``MLA_GRAD_CASES``, step 18's shapes) and at (120, 120)
(``DH120_GRAD_CASES``); and times
the captioner's prefill call, a dh = 128 call and the captioner's training
gradient with a cold L2 (``chip_smoke.Clock``).  It saves the outputs and
times to ``FILE`` (``torch.save``).  ``compare`` prints, for each file after the
first, whether every output has the first file's bits, and every file's
times: run the two checkouts in turns (A, B, B, A) in one call, so the
times share a card.  It exits non-zero when the bits differ.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (B, S, H, Kv, dh, dtype, causal, window, softcap)
CASES = ((8, 1024, 12, 4, 64, "bf16", True, 0, 0.0),
         (8, 1024, 12, 4, 64, "f32", True, 0, 0.0),
         (8, 256, 12, 4, 64, "bf16", True, 0, 0.0),
         (1, 200, 2, 2, 128, "f32", True, 0, 50.0),
         (2, 333, 12, 4, 128, "bf16", True, 100, 30.0),
         (2, 17, 12, 4, 64, "bf16", True, 0, 0.0),
         (1, 1025, 12, 4, 64, "bf16", True, 0, 0.0),
         (2, 1024, 12, 1, 64, "bf16", True, 0, 0.0),
         (1, 300, 4, 4, 64, "bf16", True, 1, 0.0),
         (1, 2048, 4, 2, 128, "bf16", False, 0, 0.0),
         (1, 200, 2, 2, 64, "f32", False, 0, 0.0),
         (2, 5000, 32, 16, 128, "bf16", True, 4096, 50.0))
TIMED = ((0, True), (9, False), (11, True))   # (case, causal) timed cold
# (B, S, H, dtype, causal) at (dqk, dv) = (192, 128): chip_smoke.py step 17
MLA_CASES = ((2, 200, 4, "bf16", True), (1, 1024, 16, "bf16", True),
             (2, 200, 4, "f32", True), (2, 200, 4, "bf16", False))
# the gradient at (64, 64) and (128, 128): chip_smoke.py step 15's shapes
GRAD_CASES = ((8, 256, 12, 4, 64, "bf16", True, 0, 0.0),
              (8, 256, 12, 4, 64, "f32", True, 0, 0.0),
              (2, 200, 12, 4, 64, "bf16", True, 0, 0.0),
              (2, 129, 12, 4, 64, "f32", True, 0, 0.0),
              (1, 256, 4, 4, 64, "bf16", True, 32, 0.0),
              (1, 256, 4, 2, 64, "f32", True, 0, 30.0),
              (2, 200, 4, 4, 64, "bf16", False, 0, 0.0),
              (2, 129, 4, 4, 128, "f32", False, 0, 0.0),
              (1, 1024, 12, 4, 128, "bf16", True, 0, 0.0),
              (1, 1024, 4, 4, 64, "f32", True, 32, 30.0),
              (2, 333, 12, 4, 128, "bf16", True, 100, 30.0))
GRAD_TIMED = 0                           # the captioner's training shape
# the gradient at (192, 128): chip_smoke.py step 18's shapes (B, S, H,
# dtype, causal)
MLA_GRAD_CASES = ((1, 129, 4, "bf16", True), (2, 200, 4, "f32", True),
                  (2, 512, 128, "bf16", True), (2, 200, 4, "bf16", False))
# (B, S, H, Kv, dtype, causal, window, softcap) at (120, 120): chip_smoke.py
# steps 19-20's shapes, h2o-danube-3-4b's prefill and training shape first
DH120_CASES = ((2, 5000, 32, 8, "bf16", True, 4096, 0.0),
               (1, 129, 4, 2, "bf16", True, 0, 0.0),
               (1, 200, 4, 2, "f32", True, 64, 50.0),
               (2, 200, 4, 2, "bf16", False, 0, 0.0))
DH120_GRAD_CASES = ((1, 5000, 32, 8, "bf16", True, 4096, 0.0),
                    (1, 129, 4, 2, "bf16", True, 0, 0.0),
                    (1, 200, 4, 2, "f32", True, 64, 50.0),
                    (2, 333, 12, 4, "bf16", True, 100, 30.0))


def run(src: str, out: str) -> None:
    import torch

    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import flash_attention as fa

    dev = resolve_device("cuda")
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    outputs = []
    for i, (B, S, H, Kv, dh, dt, causal, window, cap) in enumerate(CASES):
        q, k, v = cs.attn_inputs(torch, B, S, H, Kv, dh, dts[dt], i, dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        outputs.append((o.cpu(), lse.cpu(),
                        fa.flash_attention_cuda(q, k, v, **kw).cpu()))
    if (192, 128) in fa.HEAD_PAIRS:
        for i, (B, S, H, dt, causal) in enumerate(MLA_CASES):
            q, k, v = cs.mla_inputs(torch, B, S, H, dts[dt], 300 + i, dev)
            o, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                             return_lse=True)
            outputs.append((o.cpu(), lse.cpu()))
    dh120 = (120, 120) in fa.HEAD_PAIRS
    for i, (B, S, H, Kv, dt, causal, window, cap) in enumerate(
            DH120_CASES if dh120 else ()):
        q, k, v = cs.attn_inputs(torch, B, S, H, Kv, 120, dts[dt], 400 + i,
                                 dev)
        o, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window, softcap=cap,
                                         return_lse=True)
        outputs.append((o.cpu(), lse.cpu()))
    grads = []
    for i, (B, S, H, Kv, dh, dt, causal, window, cap) in enumerate(
            GRAD_CASES):
        q, k, v = cs.attn_inputs(torch, B, S, H, Kv, dh, dts[dt], 100 + i,
                                 dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        g = torch.Generator(device=dev).manual_seed(200 + i)
        do = torch.randn(o.shape, generator=g, device=dev).to(dts[dt])
        grads.append(tuple(t.cpu() for t in fa.flash_attention_bwd_cuda(
            q, k, v, o, do, lse, **kw)))
        if i == GRAD_TIMED:
            timed_grad = (q, k, v, o, do, lse, kw)
    if (192, 128) in fa.HEAD_PAIRS:
        for i, (B, S, H, dt, causal) in enumerate(MLA_GRAD_CASES):
            q, k, v = cs.mla_inputs(torch, B, S, H, dts[dt], 500 + i, dev)
            o, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                             return_lse=True)
            g = torch.Generator(device=dev).manual_seed(600 + i)
            do = torch.randn(o.shape, generator=g, device=dev).to(dts[dt])
            grads.append(tuple(t.cpu() for t in fa.flash_attention_bwd_cuda(
                q, k, v, o, do, lse, causal=causal)))
    for i, (B, S, H, Kv, dt, causal, window, cap) in enumerate(
            DH120_GRAD_CASES if dh120 else ()):
        q, k, v = cs.attn_inputs(torch, B, S, H, Kv, 120, dts[dt], 700 + i,
                                 dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        g = torch.Generator(device=dev).manual_seed(800 + i)
        do = torch.randn(o.shape, generator=g, device=dev).to(dts[dt])
        grads.append(tuple(t.cpu() for t in fa.flash_attention_bwd_cuda(
            q, k, v, o, do, lse, **kw)))
    outputs.extend(grads)
    clock = cs.Clock(torch)
    times = {}
    B, S, H, Kv, dh, dt = GRAD_CASES[GRAD_TIMED][:6]
    times[f"gradient B={B} S={S} H={H} Kv={Kv} dh={dh} {dt} causal"] = \
        clock.ms(lambda: fa.flash_attention_bwd_cuda(*timed_grad[:6],
                                                     **timed_grad[6]))
    for i, causal in TIMED:
        B, S, H, Kv, dh, dt = CASES[i][:6]
        q, k, v = cs.attn_inputs(torch, B, S, H, Kv, dh, dts[dt], i, dev)
        window, cap = CASES[i][7:]
        times[f"B={B} S={S} H={H} Kv={Kv} dh={dh} {dt} causal={causal} "
              f"window={window} softcap={cap}"] = clock.ms(
            lambda: fa.flash_attention_cuda(q, k, v, causal=causal,
                                            window=window, softcap=cap))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    torch.save({"src": str(src), "card": smi, "outputs": outputs,
                "times_ms": times}, out)
    print(json.dumps({"src": str(src), "card": smi, "times_ms": times}))


def compare(files) -> int:
    import torch

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32)

    runs = [torch.load(f) for f in files]
    same_all = True
    for f, r in zip(files, runs):
        same = len(r["outputs"]) == len(runs[0]["outputs"]) and all(
            torch.equal(bits(a), bits(b))
            for ra, rb in zip(runs[0]["outputs"], r["outputs"])
            for a, b in zip(ra, rb))
        same_all &= same
        print(json.dumps({"file": f, "src": r["src"], "card": r["card"],
                          "same_bits_as_first": same,
                          "times_ms": r["times_ms"]}))
    return 0 if same_all else 1


def main(argv) -> int:
    if len(argv) >= 1 and argv[0] == "run" and len(argv) == 5 \
            and argv[1] == "--src" and argv[3] == "--out":
        run(argv[2], argv[4])
        return 0
    if len(argv) >= 3 and argv[0] == "compare":
        return compare(argv[1:])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
