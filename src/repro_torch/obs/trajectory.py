"""BENCH run trajectories: append-only, git-sha-stamped benchmark history.

Port of ``repro.obs.trajectory`` (pure Python: the same code and file
format).  Each benchmark run appends one line to
``BENCH_history/<suite>.jsonl`` so the perf trajectory across changes is
a first-class artifact instead of a sequence of silent overwrites.

Provenance (git sha, date) is **passed in by the CLI**, never sampled
here: the module stays pure so library callers (tests, the gate) control
exactly what gets stamped, and nothing in the replay-deterministic code
paths ever touches the clock or the git tree.
"""
from __future__ import annotations

import json
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
HISTORY_DIR = REPO_ROOT / "BENCH_history"

__all__ = ["append_run", "load_history", "latest_run", "HISTORY_DIR"]


def _history_path(suite: str, history_dir=None) -> Path:
    return Path(history_dir or HISTORY_DIR) / f"{suite}.jsonl"


def append_run(suite: str, result: dict, *, git_sha: str, date: str,
               smoke: bool = False, history_dir=None) -> Path:
    """Append one benchmark run to ``BENCH_history/<suite>.jsonl``.

    ``git_sha``/``date`` are caller-supplied provenance strings (the CLI
    samples them once at process start).  Returns the history file path.
    """
    path = _history_path(suite, history_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    entry = {"suite": suite, "smoke": bool(smoke), "git_sha": git_sha,
             "date": date, "result": result}
    with open(path, "a") as f:
        f.write(json.dumps(entry, sort_keys=True) + "\n")
    return path


def load_history(suite: str, *, history_dir=None,
                 smoke: bool | None = None) -> list:
    """All recorded runs for ``suite``, oldest first (optionally filtered
    to smoke / full runs).  Missing history -> []."""
    path = _history_path(suite, history_dir)
    if not path.exists():
        return []
    runs = [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]
    if smoke is not None:
        runs = [r for r in runs if bool(r.get("smoke")) == smoke]
    return runs


def latest_run(suite: str, *, history_dir=None,
               smoke: bool | None = None) -> dict | None:
    """The most recent recorded run (None when there is no history)."""
    runs = load_history(suite, history_dir=history_dir, smoke=smoke)
    return runs[-1] if runs else None
