"""The ``prompts`` traffic generator: prompts for one closed-loop client,
read from a mix file of parameters (``traffic/<mix>.json`` whose
``generator`` is ``prompts``).

A serving generator module defines ``stream(mix, vocab, seed)``, whose
object has ``batch`` and ``gen`` (sequences a request, tokens it
generates), ``setup_prompts()`` (what set-up serves: the cache the traffic
needs, and a warm-up of every shape) and ``request(i)`` (the window's
``i``-th prompt, ``[batch, length]`` token ids); the mix's ``tier`` says
whether requests share one KV tier (``shared``) or each gets a fresh one
(``fresh``).

Each request is a batch of ``batch`` sequences of one length (what the
port's ``launch.serve.serve`` takes as one prompt) and generates
``gen_tokens`` tokens.

* ``pool_docs`` documents are served once in set-up, filling the KV tier
  (``tier: "shared"``).
* In the window, every ``one_off_every``-th request is a new document, a
  miss that prefills; the others draw a pool document by Zipf
  (``zipf_alpha``) over popularity ranks, hits that skip prefill.  With
  ``one_off_every`` 4 the hit share is 75 % on every seed.
* ``tier: "fresh"`` serves every request through a fresh tier: nothing is
  reused.

Lengths are log-uniform over ``length_range``, taken at fixed quantiles so
that every seed serves the same set of lengths: the pool's ``pool_docs``
lengths, and the new documents' in blocks of 8 quantiles, each block in
its own seeded order.  Token ids are uniform over the vocabulary.  The
same seed gives the same prompts.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

NEW_BLOCK = 8


def _quantile_lengths(lo: int, hi: int, n: int) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    return np.round(np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
                    ).astype(np.int64)


class PromptStream:
    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = vocab
        self.batch = int(mix["batch"])
        self.gen = int(mix["gen_tokens"])
        ss = np.random.SeedSequence([seed % 2**64,
                                     zlib.crc32(b"portbench/prompts")])
        self.rng = np.random.default_rng(ss)
        lo, hi = (int(x) for x in mix["length_range"])
        n_pool = int(mix["pool_docs"])
        self.pool_lengths = self.rng.permutation(_quantile_lengths(lo, hi, n_pool)) \
            if n_pool else np.zeros(0, np.int64)
        self.new_lengths = _quantile_lengths(lo, hi, NEW_BLOCK)
        self.pool = [self._doc(int(n)) for n in self.pool_lengths]
        if n_pool:
            w = 1.0 / np.arange(1, n_pool + 1) ** float(mix["zipf_alpha"])
            self.cdf = np.cumsum(w / w.sum())
            self.cdf[-1] = 1.0
        self._block = []

    def _doc(self, length: int) -> torch.Tensor:
        ids = self.rng.integers(0, self.vocab, (self.batch, length))
        return torch.from_numpy(ids.astype(np.int64))

    def new_doc(self) -> torch.Tensor:
        if not self._block:
            self._block = list(self.rng.permutation(self.new_lengths))
        return self._doc(int(self._block.pop()))

    def request(self, i: int) -> torch.Tensor:
        """The prompt of the window's ``i``-th request."""
        every = int(self.mix["one_off_every"])
        if not self.pool or i % every == every - 1:
            return self.new_doc()
        u = self.rng.random()
        return self.pool[min(int(np.searchsorted(self.cdf, u, side="right")),
                             len(self.pool) - 1)]

    def setup_prompts(self) -> list:
        """The pool (a shared tier), or else one document of the longest
        length the new documents take, which warms every kernel the
        window uses and is not part of the stream."""
        return self.pool if self.pool else [self.longest_new()]

    def longest_new(self) -> torch.Tensor:
        """A document of the longest length the new documents take; not
        part of the stream."""
        ids = np.random.default_rng(0).integers(
            0, self.vocab, (self.batch, int(self.new_lengths.max())))
        return torch.from_numpy(ids.astype(np.int64))


def stream(mix: dict, vocab: int, seed: int) -> PromptStream:
    return PromptStream(mix, vocab, seed)
