"""Synthetic data pipeline (port of ``repro.data.synthetic``; offline: no
downloads).

Deterministic token streams with LM-like statistics:

* Zipf-distributed unigrams (natural-language-like frequency profile),
  drawn by inverse-CDF sampling;
* a Markov "template" layer so sequences have learnable structure —
  training losses actually decrease, which the examples and tests
  assert;
* document packing with BOS/EOS markers at a fixed seq_len.

Randomness comes from ``torch.Generator``s on the CPU made from the seed,
so a seed gives the same tokens on any device; the batches are moved to
``device`` (CUDA by default).  ``jax.random``'s draws cannot be matched,
so the structure is the reference's exactly (the inverse CDF, 64 fixed
templates of 32 tokens from seed 0, 0.75 structure, BOS at position 0,
one EOS in [S/2, S)) and the numbers are not.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def zipf_cdf(vocab: int, alpha: float = 1.2) -> torch.Tensor:
    """The Zipf CDF over ranks 1..vocab: float64 probabilities, their
    cumulative sum cast to float32 (the reference's table)."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    return torch.from_numpy(np.cumsum(probs).astype(np.float32))


def zipf_from_uniform(u: torch.Tensor, vocab: int, *,
                      alpha: float = 1.2) -> torch.Tensor:
    """Token ids (int32) of uniform draws ``u`` in [0, 1): the first CDF
    entry not below each draw (``searchsorted``, left side)."""
    cdf = zipf_cdf(vocab, alpha).to(u.device)
    return torch.searchsorted(cdf, u.float()).to(torch.int32)


def zipf_tokens(gen: torch.Generator, shape, vocab: int, *,
                alpha: float = 1.2) -> torch.Tensor:
    """Zipf-distributed token ids via inverse-CDF sampling, on
    ``gen``'s device."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return zipf_from_uniform(u, vocab, alpha=alpha)


@dataclasses.dataclass
class SyntheticLM:
    """Markov-structured synthetic corpus.

    Each document interleaves a persistent "topic" n-gram template with
    Zipf noise; next-token statistics are predictable enough that a small
    model's CE visibly drops within a few hundred steps.
    """

    vocab: int
    seq_len: int
    bos: int = 1
    eos: int = 2
    structure: float = 0.75     # fraction of positions from the template
    n_templates: int = 64
    template_len: int = 32

    def templates(self) -> torch.Tensor:
        """The fixed corpus: from seed 0 whatever the stream's seed, as
        the reference's ``PRNGKey(0)``."""
        return zipf_tokens(torch.Generator().manual_seed(0),
                           (self.n_templates, self.template_len),
                           self.vocab)

    def batch(self, gen: torch.Generator, batch_size: int, *,
              device: DeviceLike = None) -> dict:
        """{"tokens": (batch_size, seq_len) int32} on ``device``, drawn
        from ``gen`` (a CPU generator)."""
        dev = resolve_device(device)
        S = self.seq_len
        templates = self.templates()
        tids = torch.randint(0, self.n_templates, (batch_size, 1),
                             generator=gen)
        reps = -(-S // self.template_len)
        body = templates[tids[:, 0]].tile(1, reps)[:, :S]
        noise = zipf_tokens(gen, (batch_size, S), self.vocab)
        use_template = torch.rand((batch_size, S),
                                  generator=gen) < self.structure
        tokens = torch.where(use_template, body, noise)
        tokens[:, 0] = self.bos
        doc_end = torch.randint(S // 2, S, (batch_size,), generator=gen)
        tokens = torch.where(torch.arange(S)[None, :] == doc_end[:, None],
                             self.eos, tokens)
        return {"tokens": tokens.to(torch.int32).to(dev)}


def lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
               device: DeviceLike = None) -> Iterator[dict]:
    """Infinite deterministic batch iterator: one generator from ``seed``
    draws every batch in turn."""
    src = SyntheticLM(vocab=vocab, seq_len=seq)
    gen = torch.Generator().manual_seed(seed)
    dev = resolve_device(device)
    while True:
        yield src.batch(gen, batch, device=dev)


def frontend_batches(batch: int, n_tokens: int, d_model: int, *,
                     seed: int = 0,
                     device: DeviceLike = None) -> Iterator[torch.Tensor]:
    """Stub modality frontend: precomputed frame/patch embeddings, normal
    with standard deviation 0.02, in bf16 on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    dev = resolve_device(device)
    while True:
        x = torch.randn((batch, n_tokens, d_model), generator=gen) * 0.02
        yield x.to(torch.bfloat16).to(dev)


__all__ = ["SyntheticLM", "frontend_batches", "lm_batches", "zipf_cdf",
           "zipf_from_uniform", "zipf_tokens"]
