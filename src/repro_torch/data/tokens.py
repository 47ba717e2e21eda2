"""Token pipeline: templated scene captions.

Port of ``repro.data.tokens`` (numpy, the same numbers from the same seed),
built on the port's own ``data.scenes.CLASS_NAMES``.  The captioner in
SemanticXR's perception stack describes objects ("a red chair near the
wooden table"); serving prompts are rows of ``batch_iterator``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.scenes import CLASS_NAMES

_ADJ = ["red", "blue", "green", "small", "large", "wooden", "metal", "old",
        "new", "round"]
_REL = ["near", "under", "above", "beside", "behind", "facing"]
_TMPL = ["a {a} {c1} {r} the {c2}", "the {c1} is {r} the {a} {c2}",
         "there is a {a} {c1} {r} the {c2}", "find the {a} {c1}"]

PAD, BOS = 0, 1
_WORDS = sorted({w for t in _TMPL for w in
                 t.replace("{a}", "").replace("{c1}", "").replace("{c2}", "")
                 .replace("{r}", "").split()} | set(_ADJ) | set(_REL)
                | set(CLASS_NAMES))
VOCAB = {w: i + 2 for i, w in enumerate(_WORDS)}
VOCAB_SIZE = len(VOCAB) + 2


def make_caption(rng: np.random.Generator) -> str:
    t = _TMPL[rng.integers(len(_TMPL))]
    return t.format(a=_ADJ[rng.integers(len(_ADJ))],
                    c1=CLASS_NAMES[rng.integers(len(CLASS_NAMES))],
                    c2=CLASS_NAMES[rng.integers(len(CLASS_NAMES))],
                    r=_REL[rng.integers(len(_REL))])


def encode(text: str) -> list[int]:
    return [VOCAB[w] for w in text.split() if w in VOCAB]


def batch_iterator(batch: int, seq: int, *, seed: int = 0, vocab_size: int):
    """Yield dicts {'tokens': [B, S] int32 numpy}; captions packed
    back-to-back, BOS-separated, token ids mapped into the model vocab."""
    rng = np.random.default_rng(seed)
    if vocab_size < VOCAB_SIZE:
        raise ValueError(f"vocab_size {vocab_size} < caption vocabulary "
                         f"{VOCAB_SIZE}")
    while True:
        out = np.zeros((batch, seq), np.int32)
        for b in range(batch):
            toks: list[int] = []
            while len(toks) < seq:
                toks.append(BOS)
                toks.extend(encode(make_caption(rng)))
            out[b] = toks[:seq]
        yield {"tokens": out}
