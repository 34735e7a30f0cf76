"""The port's wire codecs against the reference, payload byte for byte.

Inputs come from numpy with a seed and go unchanged to both packages.
Quantisation is exact arithmetic on equal floats (``torch.round`` and
``jnp.round`` both round half to even), so data, ``scale``, ``zero`` and
``wire_bytes`` are compared for equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.core import wire as j_wire
from repro_torch.core import wire as t_wire

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

SHAPES = [(1, 11, 11, 4), (1, 13, 13, 16), (1, 6, 9, 5)]


def _features(shape, seed, batch=None):
    rng = np.random.default_rng(seed)
    full = shape if batch is None else (batch,) + shape
    x = rng.random(full, dtype=np.float32)
    if batch is not None:        # distinct dynamic ranges per example
        x = x * rng.uniform(0.2, 3.0, (batch,) + (1,) * len(shape)) \
            .astype(np.float32) - rng.uniform(0, 1, (batch,) + (1,) *
                                               len(shape)).astype(np.float32)
    return x


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    t = np.asarray(t)
    return t.astype(np.float32) if t.dtype == jnp.bfloat16 else t


def _assert_payload_equal(tp, jp):
    assert set(tp) == set(jp)
    for k in jp:
        a, b = _np(tp[k]), _np(jp[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if k == "data":
            assert str(tp[k].dtype).split(".")[-1] == \
                str(jp[k].dtype).split(".")[-1], k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name", list(j_wire.CODECS))
@pytest.mark.parametrize("shape", SHAPES)
def test_encode_is_bitwise_reference(name, shape):
    x = _features(shape, seed=10 * SHAPES.index(shape)
                  + list(j_wire.CODECS).index(name))
    tp = t_wire.get_codec(name).encode(torch.from_numpy(x))
    jp = j_wire.get_codec(name).encode(jnp.asarray(x))
    _assert_payload_equal(tp, jp)
    assert t_wire.get_codec(name).wire_bytes(shape) == \
        j_wire.get_codec(name).wire_bytes(shape)
    assert t_wire.get_codec(name).wire_bytes_batch(shape, 8) == \
        j_wire.get_codec(name).wire_bytes_batch(shape, 8)


@pytest.mark.parametrize("name", list(j_wire.CODECS))
def test_encode_batch_is_per_example_and_bitwise_reference(name):
    shape = (11, 11, 4)
    x = _features(shape, seed=7, batch=5)
    tc, jc = t_wire.get_codec(name), j_wire.get_codec(name)
    tp = tc.encode_batch(torch.from_numpy(x))
    _assert_payload_equal(tp, jc.encode_batch(jnp.asarray(x)))
    # each example's slice is the single-frame payload
    for i in range(x.shape[0]):
        one = tc.encode(torch.from_numpy(x[i]))
        _assert_payload_equal({k: v[i] for k, v in tp.items()}, one)


@pytest.mark.parametrize("name", list(j_wire.CODECS))
def test_payloads_decode_across_packages(name):
    """A port payload decodes in the reference to the floats the port's own
    decode gives, and the reverse."""
    x = _features((1, 11, 11, 4), seed=11)
    tc, jc = t_wire.get_codec(name), j_wire.get_codec(name)
    tp = tc.encode(torch.from_numpy(x))
    jp = jc.encode(jnp.asarray(x))
    t_from_j = tc.decode({k: torch.from_numpy(np.array(v).copy())
                          if v.dtype != jnp.bfloat16 else
                          torch.from_numpy(np.array(v, np.float32))
                          .to(torch.bfloat16) for k, v in jp.items()})
    j_from_t = jc.decode({k: jnp.asarray(_np(v)).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else _np(v).dtype)
        for k, v in tp.items()})
    np.testing.assert_array_equal(_np(t_from_j), _np(tc.decode(tp)))
    np.testing.assert_array_equal(_np(j_from_t), _np(jc.decode(jp)))


@pytest.mark.parametrize("name", list(j_wire.CODECS))
def test_decode_batch_matches_reference(name):
    x = _features((11, 11, 4), seed=13, batch=4)
    tc, jc = t_wire.get_codec(name), j_wire.get_codec(name)
    got = _np(tc.decode_batch(tc.encode_batch(torch.from_numpy(x))))
    want = _np(jc.decode_batch(jc.encode_batch(jnp.asarray(x))))
    # the reference may fuse data*scale+zero into one rounding: 1 ulp
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=2e-7)


def test_stack_unstack_roundtrip():
    codec = t_wire.get_codec("uint8")
    xs = [_features((1, 11, 11, 4), seed=s) for s in range(8)]
    payloads = [codec.encode(torch.from_numpy(x)) for x in xs]
    stacked = t_wire.stack_payloads(payloads)
    assert tuple(stacked["data"].shape) == (8, 1, 11, 11, 4)
    assert tuple(stacked["scale"].shape) == (8,)
    assert tuple(stacked["zero"].shape) == (8,)
    for a, b in zip(t_wire.unstack_payload(stacked), payloads):
        for k in b:
            assert torch.equal(a[k], b[k])
    # stacked decode == per-request decode
    dec = codec.decode_batch(stacked)
    for i, p in enumerate(payloads):
        assert torch.equal(dec[i], codec.decode(p))
    # the reference's stack of the same payloads has the same layout
    j_stacked = j_wire.stack_payloads(
        [{k: jnp.asarray(v.numpy()) for k, v in p.items()} for p in payloads])
    for k in stacked:
        np.testing.assert_array_equal(stacked[k].numpy(), np.asarray(
            j_stacked[k]))
    with pytest.raises(ValueError, match="empty"):
        t_wire.stack_payloads([])


def test_byte_accounting_matches_reference():
    for x in (84, 100, 400):
        for n, k in ((3, 4), (3, 16), (2, 4)):
            assert t_wire.feature_bytes(x, n, k) == \
                j_wire.feature_bytes(x, n, k)
        assert t_wire.frame_bytes_rgba(x) == j_wire.frame_bytes_rgba(x)
    # the paper's standard payload: 11x11x4 codes + an 8-byte header
    assert t_wire.get_codec("uint8").wire_bytes((1, 11, 11, 4)) == 492


def test_uint8_roundtrip_error_bound():
    x = torch.from_numpy(_features((1, 11, 11, 4), seed=3))
    codec = t_wire.get_codec("uint8")
    err = (t_wire.roundtrip(codec, x) - x).abs().max().item()
    scale = codec.encode(x)["scale"].item()
    assert err <= 0.5 * scale * (1 + 1e-5)
