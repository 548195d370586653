"""The general traffic generator: what a mix's data file asks for, made from
the run's seed.

Every seed gives the same set of sizes in another order: a batch's caption
lengths are the mix's range repeated to fill the batch, then shuffled, so
every batch holds each length the same number of times (give or take one).
Token ids are CLIP BPE ids; the caption words are drawn uniformly from
ordinary vocabulary ids, which is all a random-weight model can tell apart.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

SOT, EOT = 49406, 49407
STAR = 265                       # '*' in the CLIP BPE vocab
COMMA = 267
A_PHOTO_OF = (320, 1125, 539)
WORD_IDS = (1000, 40000)         # the range caption words are drawn from
CONTEXT = 77


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def caption_lengths(r: np.random.Generator, batch: int, lo: int, hi: int) -> np.ndarray:
    """``batch`` lengths covering lo..hi evenly, in a shuffled order."""
    span = np.arange(lo, hi + 1)
    return r.permutation(np.resize(span, batch))


def _tokens(r: np.random.Generator, head: Sequence[int], lengths: np.ndarray) -> np.ndarray:
    rows = np.zeros((len(lengths), CONTEXT), np.int32)
    rows[:, 0] = SOT
    rows[:, 1:1 + len(head)] = head
    start = 1 + len(head)
    words = r.integers(*WORD_IDS, size=(len(lengths), int(lengths.max())))
    for i, n in enumerate(lengths):
        rows[i, start:start + n] = words[i, :n]
        rows[i, start + n] = EOT
    return rows


def composed_prompts(r: np.random.Generator, batch: int, lo: int, hi: int) -> np.ndarray:
    """(batch, 77) rows of "a photo of * , <caption>" with captions of
    lo..hi words: a composed query's prompt."""
    return _tokens(r, (*A_PHOTO_OF, STAR, COMMA), caption_lengths(r, batch, lo, hi))


def captions(r: np.random.Generator, batch: int, lo: int, hi: int) -> np.ndarray:
    """(batch, 77) plain captions of lo..hi words: a training pair's text."""
    return _tokens(r, (), caption_lengths(r, batch, lo, hi))


def real_lengths(rows: np.ndarray) -> np.ndarray:
    """Tokens up to and including each row's EOT."""
    return np.argmax(rows == EOT, axis=1) + 1


def image_pool(n_batches: int, batch: int, px: int, gen: torch.Generator) -> np.ndarray:
    """(n_batches, batch, px, px, 3) uint8 NHWC images on the host, made on
    the generator's device in one call and copied back once."""
    x = torch.randint(0, 256, (n_batches, batch, px, px, 3), generator=gen,
                      device=gen.device, dtype=torch.uint8)
    return x.cpu().numpy()
