"""Run one cell of the port's benchmark on the card and print its result.

    python3 xrbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``src/repro_torch``).
The last line of standard output is the result's JSON object; the numbers
the check compared, each with its limit, are the last lines of standard
error.  The run exits non-zero, printing no result, where the program is
missing, where no CUDA card is present (or fewer than the cell asks for),
or where JAX or the JAX package was loaded in this process.  Every build
and kernel cache lies under the checkout's ``build/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _env() -> None:
    """Fixed cache directories inside the checkout; no JAX behind a
    library's back."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def fail(msg: str, code: int) -> int:
    print(f"xrbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        return fail(f"the program is not in this checkout ({ROOT / 'src'})",
                    2)
    from xrbench import core

    entry = {w["name"]: w for w in core.benchmark()["workloads"]}.get(
        args.workload)
    if entry is None:
        return fail(f"no cell {args.workload!r} in BENCHMARK.json", 2)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: torch.cuda.is_available() is False", 3)
    if torch.cuda.device_count() < entry["chips"]:
        return fail(f"{args.workload} needs {entry['chips']} cards; "
                    f"{torch.cuda.device_count()} present", 3)
    result = core.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", t_start=T_START)
    bad = core.forbidden_modules(list(sys.modules))
    if bad:
        return fail(f"modules loaded that the benchmark forbids: {bad}", 4)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
