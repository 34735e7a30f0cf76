"""The port's synthetic LM data against the reference on the CPU.

``jax.random``'s threefry draws cannot be matched by a
``torch.Generator``, so the inverse CDF is held on the reference's own
uniform draws (token for token), and the batches are held to the
reference's structure and to the reference's three data tests
(``tests/test_data_trainer.py``): the Zipf profile, determinism with BOS
at position 0, and a learnable bigram structure.
"""
import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.data import SyntheticLM as JSyntheticLM
from repro.data import zipf_tokens as j_zipf_tokens

from repro_torch.data import (SyntheticLM, frontend_batches, lm_batches,
                              zipf_tokens)
from repro_torch.data.synthetic import zipf_from_uniform

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)


@pytest.mark.parametrize("vocab", [1000, 151936])
def test_inverse_cdf_equals_the_reference_on_its_draws(vocab):
    key = jax.random.PRNGKey(11)
    u = np.array(jax.random.uniform(key, (4096,)))
    want = np.asarray(j_zipf_tokens(key, (4096,), vocab))
    got = zipf_from_uniform(torch.from_numpy(u), vocab)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_zipf_tokens_distribution():
    toks = zipf_tokens(torch.Generator().manual_seed(0), (20_000,), 1000)
    assert int(toks.min()) >= 0 and int(toks.max()) < 1000
    # zipf: rank-0 strictly more frequent than rank-100
    counts = np.bincount(toks.numpy(), minlength=1000)
    assert counts[0] > counts[100] > 0


def test_synthetic_lm_batches_deterministic():
    it1 = lm_batches(512, 2, 64, seed=7, device="cpu")
    it2 = lm_batches(512, 2, 64, seed=7, device="cpu")
    b1, b2 = next(it1), next(it2)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (2, 64) and b1["tokens"].dtype == \
        torch.int32
    assert int(b1["tokens"][0, 0]) == 1  # BOS
    # the stream moves on, and another seed gives another stream
    assert not torch.equal(next(it1)["tokens"], b1["tokens"])
    assert not torch.equal(next(lm_batches(512, 2, 64, seed=8,
                                           device="cpu"))["tokens"],
                           b1["tokens"])


def test_synthetic_lm_learnable_structure():
    """Template layer makes next-token stats predictable: a bigram model
    beats uniform by a wide margin."""
    src = SyntheticLM(vocab=64, seq_len=128, structure=0.9)
    toks = src.batch(torch.Generator().manual_seed(0), 16,
                     device="cpu")["tokens"].numpy()
    big = np.ones((64, 64))
    for row in toks:
        for a, b in zip(row[:-1], row[1:]):
            big[a, b] += 1
    big /= big.sum(1, keepdims=True)
    nll = -np.mean([np.log(big[a, b]) for row in toks
                    for a, b in zip(row[:-1], row[1:])])
    assert nll < np.log(64) * 0.8


def test_batches_keep_the_reference_structure():
    """BOS at 0, one EOS in [S/2, S), the rest template or Zipf noise; the
    templates are 64 of 32 tokens, fixed whatever the stream's seed."""
    src = SyntheticLM(vocab=1024, seq_len=96)
    ref = JSyntheticLM(vocab=1024, seq_len=96)
    for name in ("bos", "eos", "structure", "n_templates", "template_len"):
        assert getattr(src, name) == getattr(ref, name)
    templates = src.templates()
    assert templates.shape == (64, 32) and torch.equal(templates,
                                                       src.templates())
    toks = src.batch(torch.Generator().manual_seed(3), 32,
                     device="cpu")["tokens"]
    assert (toks[:, 0] == src.bos).all()
    assert ((toks[:, 48:] == src.eos).sum(1) >= 1).all()
    # every row is its template's tiling where it does not hold noise:
    # most positions agree with one template
    tiled = templates.tile(1, 3)[:, :96]
    agree = (toks[:, None, 1:] == tiled[None, :, 1:]).float().mean(-1)
    assert (agree.amax(1) > 0.6).all()


def test_frontend_batches():
    it = frontend_batches(2, 16, 32, seed=1, device="cpu")
    a, b = next(it), next(it)
    assert a.shape == (2, 16, 32) and a.dtype == torch.bfloat16
    assert not torch.equal(a, b)
    assert 0.01 < float(a.float().std()) < 0.03
    assert torch.equal(a, next(frontend_batches(2, 16, 32, seed=1,
                                                device="cpu")))
