"""The comparison that decides ``correct``.

Once the window has closed, a sample of its finished batches, drawn from
the seed, is run through the plain reference: each batch's prompts with
the tokens the program served.  At every served position the served
token's reference logit is compared with the reference's best there.  A
cell holds statistics of these gaps to limits of its own (the ``limits``
of ``workloads/<cell>.json``): the widest gap catches a token served
wrong, the 95th percentile a path computed in too low a precision.  The
control (``control_gaps``) reads, at the same positions, the gap of the
token that a lower precision puts first.
"""
from __future__ import annotations

import random

import torch


def sample(n_batches: int, n_check: int, seed: int) -> list:
    """Indices of the batches to check, drawn from ``seed``."""
    idx = list(range(n_batches))
    if n_batches <= n_check:
        return idx
    return sorted(random.Random(seed).sample(idx, n_check))


def served_gaps(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """ref [B, P, V] f32 logits, served [B, P] token ids -> [B, P] gaps:
    the reference's best logit minus the served token's."""
    served = served.to(ref.device).long()
    return ref.amax(-1) - ref.gather(-1, served[..., None])[..., 0]


def control_gaps(ref: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """The gaps of the tokens that ``other``'s logits put first."""
    return served_gaps(ref, other.argmax(-1))


def gap_stats(gaps: list) -> dict:
    """The numbers a cell may compare, over every served token checked:
    the widest gap and the 95th percentile of the gaps."""
    g = torch.cat([x.flatten().float().cpu() for x in gaps])
    return {"widest_gap": float(g.max()),
            "gap_p95": float(torch.quantile(g, 0.95))}


def compared(stats: dict, limits: dict, nonfinite: int,
             flash_off: int) -> dict:
    """Each number compared, with its limit: the gap statistics the cell
    names in ``limits``, ``nonfinite_batches`` (batches with a logit not
    finite) and ``flash_launch_error`` (flash forward launches a prefill,
    off the count of attention layers)."""
    out = {name: {"value": stats[name], "limit": lim}
           for name, lim in limits.items()}
    out["nonfinite_batches"] = {"value": nonfinite, "limit": 0}
    out["flash_launch_error"] = {"value": flash_off, "limit": 0}
    return out


def passes(comp: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in comp.values())
