"""Calibration token streams (numpy, so that a seed gives the same tokens as
the JAX package's mobilequant_tpu/data/calib.py, bit for bit).

synthetic_tokens    a deterministic Zipf-like token stream, not a real
                    corpus: for pipeline tests and runs on the card while no
                    text or tokenizer is in the repository
add_random_samples  interleave one uniform-random-id sample after each sample
                    (the reference's --use_rand_samples augmentation)
"""

from __future__ import annotations

import numpy as np


def synthetic_tokens(vocab_size: int, nsamples: int = 128, seqlen: int = 2048,
                     seed: int = 1337) -> np.ndarray:
    """(nsamples, seqlen) int32 ids drawn with a 1/rank marginal, so that
    activation ranges look like natural text's."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    return rng.choice(vocab_size, size=(nsamples, seqlen), p=p).astype(np.int32)


def add_random_samples(samples: np.ndarray, vocab_size: int, seed: int = 1337,
                       lo: int = 2) -> np.ndarray:
    """(n, T) -> (2n, T): each sample followed by one of uniform random ids in
    [lo, vocab_size - 1), past bos and short of the last special id, so that
    the collected ranges also cover extremes that natural text never reaches."""
    rng = np.random.default_rng(seed)
    n, seqlen = samples.shape
    rand = rng.integers(lo, vocab_size - 1, (n, seqlen)).astype(samples.dtype)
    out = np.empty((2 * n, seqlen), samples.dtype)
    out[0::2], out[1::2] = samples, rand
    return out
