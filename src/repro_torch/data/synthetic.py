# Copied from src/repro/data/synthetic.py unchanged (numpy only).
"""Synthetic datasets (CIFAR-10 / ImageNet / web-text are unavailable offline).

Two generators, both deterministic in (seed, index) so any host/shard can
reproduce any element without coordination -- the property that makes the
pipeline elastic (a restarted or re-sharded job skips ahead by global step):

* SyntheticImages -- a 10-class image task with class-dependent Gaussian
  texture + frequency patterns; a small CNN reaches >90% accuracy, giving the
  quantization search a meaningful accuracy signal.
* TokenStream -- Zipf-distributed token sequences with a deterministic
  next-token structure (affine-congruential in the class index), so a tiny
  LM trained on it beats the unigram baseline and quantization hurts
  measurably.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticImages:
    n_classes: int = 10
    img_size: int = 16
    channels: int = 3
    seed: int = 0

    def _protos(self):
        rng = np.random.default_rng(self.seed)
        return rng.normal(size=(self.n_classes, self.img_size, self.img_size,
                                self.channels)).astype(np.float32)

    def batch(self, index: int, batch_size: int):
        """Deterministic batch `index`: (x (B,H,W,C), y (B,))."""
        rng = np.random.default_rng((self.seed, index))
        protos = self._protos()
        y = rng.integers(0, self.n_classes, size=batch_size)
        noise = rng.normal(scale=1.0, size=(batch_size, self.img_size,
                                            self.img_size, self.channels))
        x = protos[y] + noise.astype(np.float32)
        return {"x": x.astype(np.float32), "y": y.astype(np.int32)}


@dataclasses.dataclass
class TokenStream:
    vocab: int = 256
    seed: int = 0
    zipf_a: float = 1.2

    def batch(self, index: int, batch_size: int, seq_len: int):
        """Deterministic LM batch: tokens[t+1] = (a*tokens[t] + b) % vocab
        with per-sequence (a, b) drawn from a small set, plus Zipf noise.
        Labels are next tokens (shifted)."""
        rng = np.random.default_rng((self.seed, index))
        a = rng.choice([1, 3, 5, 7], size=(batch_size, 1))
        b = rng.integers(0, self.vocab, size=(batch_size, 1))
        t0 = rng.integers(0, self.vocab, size=(batch_size, 1))
        toks = np.zeros((batch_size, seq_len + 1), np.int64)
        toks[:, :1] = t0
        for t in range(seq_len):
            nxt = (a[:, 0] * toks[:, t] + b[:, 0]) % self.vocab
            flip = rng.random(batch_size) < 0.1
            noise = np.minimum(rng.zipf(self.zipf_a, batch_size) - 1,
                               self.vocab - 1)
            toks[:, t + 1] = np.where(flip, noise, nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def make_image_batch(index: int, batch_size: int, img_size: int = 16,
                     seed: int = 0):
    return SyntheticImages(img_size=img_size, seed=seed).batch(index,
                                                               batch_size)


def make_lm_batch(index: int, batch_size: int, seq_len: int,
                  vocab: int = 256, seed: int = 0):
    return TokenStream(vocab=vocab, seed=seed).batch(index, batch_size,
                                                     seq_len)
