"""Synthetic datasets with learnable structure, a numpy copy of
``repro/data/synthetic.py``: ``lm_corpus`` (tokens for the LM training CLI),
``image_dataset`` and ``batched``.  The same seed gives the same arrays,
bit for bit, as the reference's."""
from __future__ import annotations

import numpy as np

__all__ = ["lm_corpus", "image_dataset", "batched"]


def lm_corpus(num_tokens: int, vocab: int, seed: int = 0) -> np.ndarray:
    """Order-2 Markov chain over a Zipf vocabulary: with probability 0.75
    a token follows its predecessor into the predecessor's band of the
    vocabulary, else it jumps uniformly.  int32 tokens."""
    rng = np.random.default_rng(seed)
    # sparse transition structure: each (prev % 64) picks a preferred band
    ranks = np.arange(1, vocab + 1)
    base_p = 1.0 / ranks
    base_p /= base_p.sum()
    toks = np.empty(num_tokens, np.int32)
    toks[0] = 0
    band = max(vocab // 64, 4)
    uniform = rng.random(num_tokens)
    jumps = rng.integers(0, vocab, num_tokens)
    zipf_draws = rng.choice(vocab, size=num_tokens, p=base_p)
    for i in range(1, num_tokens):
        prev = toks[i - 1]
        if uniform[i] < 0.75:
            toks[i] = (prev * 31 + zipf_draws[i]) % band + (prev % 64) * band \
                if (prev % 64) * band + band <= vocab else zipf_draws[i]
        else:
            toks[i] = jumps[i]
    return toks


def image_dataset(n: int, size: int = 32, channels: int = 3,
                  num_classes: int = 10, seed: int = 0, noise: float = 0.35):
    """Class-conditional patterns: class c => stripes of frequency c+1 in a
    class-specific channel mix, plus Gaussian noise.  NHWC float32 images
    and int32 labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    xs = np.zeros((n, size, size, channels), np.float32)
    grid = np.arange(size, dtype=np.float32)
    for c in range(num_classes):
        idx = labels == c
        k = idx.sum()
        if k == 0:
            continue
        freq = (c % 5) + 1
        vertical = c % 2 == 0
        stripe = np.sin(2 * np.pi * freq * grid / size)
        img = np.tile(stripe[:, None] if vertical else stripe[None, :],
                      (1, size) if vertical else (size, 1))
        mix = np.zeros(channels, np.float32)
        mix[c % channels] = 1.0
        mix[(c // channels) % channels] += 0.5
        xs[idx] = img[None, :, :, None] * mix[None, None, None, :]
    xs += noise * rng.standard_normal(xs.shape).astype(np.float32)
    return xs, labels


def batched(arrays, batch_size: int, seed: int = 0, shuffle: bool = True):
    """Yield dict batches from equal-length arrays (dict of np arrays)."""
    n = len(next(iter(arrays.values())))
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n) if shuffle else np.arange(n)
    for s in range(0, n - batch_size + 1, batch_size):
        sel = idx[s:s + batch_size]
        yield {k: v[sel] for k, v in arrays.items()}
