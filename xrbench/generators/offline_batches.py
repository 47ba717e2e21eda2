"""Offline batches in a closed loop: the general generator of every traffic
mix whose ``generator`` is "offline_batches".

Parameters (the mix's file): ``batch`` rows of ``prompt`` random tokens,
``new_tokens`` tokens served a row.  Batch ``i``'s prompts are drawn on the
device from ``(seed, i)``, so every seed gives the same sizes and the
reference can draw them again.  A batch is prefilled into fresh caches
through the model API's ``prefill`` and decoded greedily through
``decode`` (the first served token comes from the prefill, each later one
from a decode step).  The window starts batches while its clock is under
``seconds`` and ends when the last one has finished.
"""
from __future__ import annotations

import time

import torch

from xrbench.weights import group_seed

PROMPT_STREAM = 1 << 20          # prompt generators' group indices


def prompts(traffic: dict, seed: int, index: int, vocab: int, device):
    gen = torch.Generator(device=device).manual_seed(
        group_seed(seed, PROMPT_STREAM + index))
    return torch.randint(0, vocab, (traffic["batch"], traffic["prompt"]),
                         generator=gen, device=device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(api, model, tokens: torch.Tensor, new_tokens: int) -> dict:
    """Prefill ``tokens`` [B, S] and serve ``new_tokens`` a row.  Returns
    host-clock seconds of the prefill and of the decode steps, the steps,
    the tokens served [B, new_tokens] (on the host), whether every logit
    was finite and the flash launches of the prefill."""
    from repro_torch.kernels import ops
    from repro_torch.models.lm import greedy_token

    B, S = tokens.shape
    dev = tokens.device
    _sync(dev)
    t0 = time.perf_counter()
    caches = api.init_cache(B, S + new_tokens, device=dev)
    n0 = ops.launch_counts()["flash_attention"]
    with torch.profiler.record_function("xrbench.prefill"):
        logits, caches = api.prefill(model, {"tokens": tokens}, caches)
        _sync(dev)
    t1 = time.perf_counter()
    flash = ops.launch_counts()["flash_attention"] - n0
    finite = torch.isfinite(logits).all()
    tok = greedy_token(logits)
    served = [tok]
    with torch.profiler.record_function("xrbench.decode"):
        for i in range(new_tokens - 1):
            logits, caches = api.decode(model, tok, caches, S + i)
            finite = finite & torch.isfinite(logits).all()
            tok = greedy_token(logits)
            served.append(tok)
        out = torch.cat(served, dim=1).cpu()
    t2 = time.perf_counter()
    return {"prefill_s": t1 - t0, "decode_s": t2 - t1,
            "steps": new_tokens - 1, "served": out,
            "finite": bool(finite), "flash_launches": flash}


def run_batch(api, model, traffic, seed, index, vocab, device) -> dict:
    rec = serve_batch(api, model, prompts(traffic, seed, index, vocab,
                                          device), traffic["new_tokens"])
    rec["index"] = index
    rec["tokens"] = traffic["batch"] * (traffic["prompt"]
                                        + traffic["new_tokens"])
    return rec


def window(api, model, traffic, seed, seconds, vocab, device) -> tuple:
    """(batch records, the window's seconds): whole batches, started while
    the clock is under ``seconds``."""
    batches = []
    _sync(device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        batches.append(run_batch(api, model, traffic, seed, len(batches),
                                 vocab, device))
    return batches, time.perf_counter() - t0


def calls(traffic: dict) -> list:
    """(rows, new positions, context) of each model call a batch makes."""
    B, S, n = traffic["batch"], traffic["prompt"], traffic["new_tokens"]
    return [(B, S, S)] + [(B, 1, S + i + 1) for i in range(n - 1)]


def served_sequences(traffic: dict, seed: int, rec: dict, vocab: int,
                     device) -> torch.Tensor:
    """A batch's prompts followed by its served tokens but the last: the
    sequence the reference reads, [B, prompt + new_tokens - 1]."""
    p = prompts(traffic, seed, rec["index"], vocab, device)
    return torch.cat([p, rec["served"][:, :-1].to(device, p.dtype)], dim=1)
