"""Readings that a cell's ``widest_gap`` limit is set from, on the card.

    python3 xrbench/control.py --workload <cell> --seeds 1,2,3 [--control-seeds 3]

For each seed, in one process: the program serves as many batches as a run
checks (the cell's own sizes), its weights are freed, and the reference
reads the served tokens, as a run's check does: the program's widest gap
is the lower reading.  On the first ``--control-seeds`` seeds the
reference also runs in
float8 (e4m3) in the program's place and the gap of the token that it puts
first at each served position is read: its widest gap is the control's,
which the limit has to fail.  One JSON line a seed on standard output.
The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, _env  # noqa: E402


def stats(name: str, gaps: list) -> dict:
    """The candidates for a compared number, over every served token."""
    import torch

    g = torch.cat([x.flatten().float().cpu() for x in gaps])
    out = {"widest_gap": float(g.max()), "mean_gap": float(g.mean()),
           "gap_p95": float(torch.quantile(g, 0.95)),
           "gap_p99": float(torch.quantile(g, 0.99)),
           "tokens_off_best": int((g > 0).sum()), "served": g.numel()}
    return {f"{name}_{k}": v for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="the control runs on this many of the seeds, first")
    args = ap.parse_args(argv)
    _env()
    import torch

    from repro_torch.models.api import model_api
    from repro_torch.models.lm import LM
    from xrbench import check, core, weights

    if not torch.cuda.is_available():
        print("xrbench: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    wl = core.load("workloads", args.workload)
    conf = core.load("configs", wl["config"])
    traffic = core.load("traffic", wl["traffic"])
    ref, adapter = core.family(conf)
    gen = core.generator(traffic)
    cfg = adapter.arch_config(conf, torch)
    api = model_api(cfg)
    lay = ref.layout(conf)
    core.check_layout(lay, api.param_specs())
    vocab = conf["vocab_size"]
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        control = n < args.control_seeds
        kinds = ("f32", "fp8") if control else ("f32",)
        t0 = time.perf_counter()
        model = LM(cfg, weights.draw_model(lay, seed, dev), device=dev)
        recs = [gen.run_batch(api, model, traffic, seed, i, vocab, dev)
                for i in range(wl["check"]["batches"])]
        del model
        core._free(dev)
        t1 = time.perf_counter()
        seqs = [gen.served_sequences(traffic, seed, r, vocab, dev)
                for r in recs]
        logits = ref.served_logits(conf, seed, seqs, traffic["prompt"], dev,
                                   kinds=kinds)
        row = {"workload": args.workload, "seed": seed,
               "program_s": t1 - t0, "reference_s": time.perf_counter() - t1}
        gaps = [check.served_gaps(lg, r["served"])
                for lg, r in zip(logits["f32"], recs)]
        row.update(stats("program", gaps))
        if control:
            row.update(stats("control", [
                check.control_gaps(a, b) for a, b in
                zip(logits["f32"], logits["fp8"])]))
        # a token altered where it is produced: one served token a batch,
        # at a position drawn from the seed, replaced by a random token
        rng = torch.Generator().manual_seed(seed)
        alt = []
        for lg, r in zip(logits["f32"], recs):
            toks = r["served"].clone()
            b = int(torch.randint(toks.shape[0], (1,), generator=rng))
            t = int(torch.randint(toks.shape[1], (1,), generator=rng))
            toks[b, t] = int(torch.randint(vocab, (1,), generator=rng))
            alt.append(check.served_gaps(lg, toks))
        row["altered_widest_gap"] = stats("altered", alt)["altered_widest_gap"]
        row["finite"] = all(r["finite"] for r in recs)
        row["logit_std"] = float(logits["f32"][0].std())
        print(json.dumps(row), flush=True)
        del logits, seqs
        core._free(dev)
    print(json.dumps({"total_s": time.perf_counter() - T_START,
                      "root": ROOT.name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
