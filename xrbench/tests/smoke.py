"""Smoke sizes of the benchmark's configurations and mixes, for CPU tests."""
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def conf(name: str, **sizes) -> dict:
    c = json.loads((HERE / "configs" / f"{name}.json").read_text())
    c.update(sizes)
    return c


def jamba() -> dict:
    return conf("jamba-v0.1-52b-2p", hidden_size=64, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=96, vocab_size=512,
                num_experts=4, num_hidden_layers=8, mamba_d_state=4,
                mamba_dt_rank=8, mamba_chunk=8)


def rwkv6() -> dict:
    return conf("rwkv6-3b", hidden_size=64, attention_hidden_size=64,
                head_size=16, intermediate_size=96, vocab_size=512,
                num_hidden_layers=3, time_mix_extra_dim=8,
                time_decay_extra_dim=8, wkv_chunk=8)


def traffic(batch=2, prompt=20, new_tokens=4) -> dict:
    return {"generator": "offline_batches", "batch": batch, "prompt": prompt,
            "new_tokens": new_tokens}


def workload(config: str, mix: str, limits: dict, batches: int = 2) -> dict:
    return {"config": config, "traffic": mix,
            "check": {"batches": batches, "limits": limits}}


def loose() -> dict:
    """Limits no sound or broken smoke run reaches."""
    return {"widest_gap": 100.0, "gap_p95": 100.0}
