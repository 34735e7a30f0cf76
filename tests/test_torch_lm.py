"""The port's LM split-serving path against the reference on the CPU.

Reduced qwen3-0.6b (2 layers, d 256, 4/4 heads, head_dim 32, vocab 1024,
f32) with the reference's own ``DecoderModel.init`` parameters, converted
with ``params_from_jax``; tokens from numpy with a seed.  Tolerances:
logits and split halves 1e-4 in f32 (the two frameworks sum in other
orders); the split against the monolith 1e-3, as the reference's own
test; bf16 logits 5e-2 with top-1 agreement >= 0.95 (XLA rounds
``_scores_to_out``'s bf16 einsum outputs where torch's CPU matmul rounds
elsewhere).  Configs, wire bytes and the decision-latency model are exact.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import ARCHS as J_ARCHS
from repro.core.wire import get_codec as j_get_codec
from repro.launch.serve import build_split as j_build_split
from repro.models.registry import get_model as j_get_model
from repro.models.transformer import DecoderModel as JDecoder
from repro.serving.client import DecisionLoop as JLoop
from repro.serving.netsim import shaped as j_shaped

from repro_torch.models.config import port_only_dict
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.wire import get_codec
from repro_torch.launch import serve as t_serve
from repro_torch.models.registry import build_model, get_model
from repro_torch.models.transformer import DecoderModel
from repro_torch.models.whisper import WhisperModel
from repro_torch.serving.client import DecisionLoop
from repro_torch.serving.netsim import shaped

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

ARCH = "qwen3-0.6b"


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(3, vocab, shape,
                                                dtype=np.int32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def reduced():
    """(port cfg, port model, port params, ref model, ref params)."""
    jcfg, jmodel = j_get_model(ARCH, reduced=True)
    jp = jmodel.init(jax.random.PRNGKey(0))
    cfg, model = get_model(ARCH, reduced=True)
    return cfg, model, params_from_jax(jp, device="cpu"), jmodel, jp


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_configs_equal_the_reference(arch):
    cfg, ref = ARCHS[arch], J_ARCHS[arch]
    assert port_only_dict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert port_only_dict(cfg.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert cfg.blocks() == ref.blocks()
    assert get_config(arch) is cfg


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m",
                                  "qwen2-moe-a2.7b", "whisper-medium"])
def test_family_builds(arch):
    """Every family builds; the audio family's model is the
    encoder–decoder ``WhisperModel``."""
    want = WhisperModel if ARCHS[arch].family == "audio" else DecoderModel
    model = build_model(ARCHS[arch])
    assert type(model) is want and model.cfg is ARCHS[arch]
    assert type(build_model(ARCHS[arch].reduced())) is want


def test_llava_backbone_builds():
    assert isinstance(build_model(ARCHS["llava-next-mistral-7b"].reduced()),
                      DecoderModel)


# ---------------------------------------------------------------------------
# weights carried across
# ---------------------------------------------------------------------------

def test_bf16_tree_converts_bit_for_bit():
    cfg = dataclasses.replace(J_ARCHS[ARCH].reduced(), dtype="bfloat16")
    jp = JDecoder(cfg).init(jax.random.PRNGKey(3))
    tp = params_from_jax(jp, device="cpu")
    jl, _ = jax.tree_util.tree_flatten_with_path(jp)
    assert tp["scan"]["b0_attn"]["attn"]["wq"]["kernel"].shape[0] == \
        cfg.n_pattern
    for path, leaf in jl:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            np.asarray(leaf.astype(jnp.float32)), t.float().numpy())


def test_port_init_shapes_match_the_reference(reduced):
    cfg, model, tp, _, jp = reduced
    own = model.init(torch.Generator().manual_seed(0), device="cpu")
    flat_t, flat_j = dict(_flatten(own)), dict(_flatten(jp))
    assert flat_t == flat_j
    assert sum(int(np.prod(s)) for s in flat_t.values()) == \
        cfg.param_count() + cfg.n_layers * 2 * cfg.head_dim \
        + (2 * cfg.n_layers + 1) * cfg.d_model


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tuple(v.shape)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16), (1, 128)])
def test_forward_matches(reduced, shape):
    cfg, model, tp, jmodel, jp = reduced
    tok = _tokens(shape, cfg.vocab)
    got, aux = model.forward(tp, torch.from_numpy(tok))
    want, _ = jmodel.forward(jp, jnp.asarray(tok))
    assert got.shape == (*shape, cfg.vocab) and got.dtype == torch.float32
    assert float(aux["moe_aux_loss"]) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


def test_split_halves_match_and_equal_the_monolith(reduced):
    cfg, model, tp, jmodel, jp = reduced
    tok = _tokens((2, 16), cfg.vocab)
    te, ts = model.split_params(tp, 1)
    je, js = jmodel.split_params(jp, 1)
    h = model.edge_forward(te, torch.from_numpy(tok))
    jh = jmodel.edge_forward(je, jnp.asarray(tok))
    np.testing.assert_allclose(_np(h), _np(jh), atol=1e-4, rtol=1e-4)
    # each server half on the same boundary hidden
    logits = model.server_forward(ts, torch.from_numpy(np.array(jh)))
    jlogits = jmodel.server_forward(js, jh)
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=1e-4,
                               rtol=1e-4)
    mono, _ = model.forward(tp, torch.from_numpy(tok))
    np.testing.assert_allclose(_np(model.server_forward(ts, h)), _np(mono),
                               atol=1e-3, rtol=1e-3)


def test_bf16_model_tracks_the_reference():
    jcfg = dataclasses.replace(J_ARCHS[ARCH].reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(ARCHS[ARCH].reduced(), dtype="bfloat16")
    jmodel, model = JDecoder(jcfg), DecoderModel(cfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    tok = _tokens((2, 16), cfg.vocab, seed=4)
    got, _ = model.forward(params_from_jax(jp, device="cpu"),
                           torch.from_numpy(tok))
    want, _ = jmodel.forward(jp, jnp.asarray(tok))
    assert got.dtype == torch.bfloat16
    g, w = _np(got), _np(want)
    top1 = float(np.mean(g.argmax(-1) == w.argmax(-1)))
    print(f"bf16 reduced qwen3: top-1 agreement {top1:.4f}, max_abs_err "
          f"{np.abs(g - w).max():.4g}")
    np.testing.assert_allclose(g, w, atol=5e-2, rtol=5e-2)
    assert top1 >= 0.95


# ---------------------------------------------------------------------------
# wire and latency
# ---------------------------------------------------------------------------

def test_boundary_payload_is_bitwise_the_reference(reduced):
    cfg, model, tp, jmodel, jp = reduced
    je, _ = jmodel.split_params(jp, 1)
    h = np.array(jmodel.edge_forward(je, jnp.asarray(
        _tokens((2, 16), cfg.vocab))))
    got = get_codec("uint8").encode(torch.from_numpy(h))
    want = j_get_codec("uint8").encode(jnp.asarray(h))
    assert got["data"].dtype == torch.uint8 and got["data"].shape == h.shape
    for k in ("data", "scale", "zero"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("codec", ["uint8", "float32", "int8_channel"])
def test_build_split_byte_counts(codec):
    kw = dict(reduced=True, edge_segments=1, codec_name=codec, batch=2,
              seq=16)
    got = t_serve.build_split(ARCH, device="cpu", **kw)
    want = j_build_split(ARCH, **kw)
    assert got[5:] == want[5:]
    assert tuple(got[4].shape) == tuple(want[4].shape)
    assert port_only_dict(got[0]) == dataclasses.asdict(want[0])


@pytest.mark.parametrize("mbps,server_s,edge_s,wire,raw", [
    (10.0, 0.004, 0.001, 131080, 512), (25.0, 0.0021, 0.0004, 4104, 64),
    (100.0, 0.03, 0.0, 32776, 4096), (1.5, 0.0007, 0.00015, 492, 28224)])
def test_decision_latency_equals_the_reference(mbps, server_s, edge_s, wire,
                                               raw):
    for split, payload in ((False, raw), (True, wire)):
        got = DecisionLoop(link=shaped(mbps), server_time_s=server_s,
                           split=split, edge_time_s=edge_s,
                           payload_bytes=payload).median_latency(100)
        want = JLoop(link=j_shaped(mbps), server_time_s=server_s,
                     split=split, edge_time_s=edge_s,
                     payload_bytes=payload).median_latency(100)
        assert got == want


def test_cli_prints_the_reference_table():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = t_serve.main(["--device", "cpu", "--seq", "16", "--bandwidths",
                           "10,100"])
    lines = out.getvalue().splitlines()
    assert rc == 0 and len(lines) == 4, lines
    assert lines[0].startswith(f"{ARCH} split@1 codec=uint8: edge ")
    assert lines[0].endswith(" wire 4104B raw 64B")
    assert lines[1] == f"{'Mb/s':>8} {'server-only(ms)':>16} {'split(ms)':>11}"
    assert [l.split()[0] for l in lines[2:]] == ["10", "100"]
    assert all(len(l.split()) == 3 for l in lines[2:])


def test_entry_points_refuse_cuda_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_serve.build_split(ARCH, reduced=True, edge_segments=1,
                            codec_name="uint8", batch=1, seq=16)


# ---------------------------------------------------------------------------
# examples.serve_split_llm against the reference's example
# ---------------------------------------------------------------------------

def _reference_example():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "ref_serve_split_llm", os.path.join(os.path.dirname(__file__), "..",
                                            "examples", "serve_split_llm.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    return ref


def _table(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(argv)
    return out.getvalue().splitlines(), result


def test_serve_split_llm_prints_the_reference_table():
    """The same header, codecs, columns, wire megabytes and 1 Gb/s transfer
    times as the reference's example; the float32 codec's logits are the
    uncoded split's, bit for bit, and the bf16 codec's agree on top-1."""
    from repro_torch.examples import serve_split_llm
    argv = ["--batch", "2", "--seq", "16"]
    got, rows = _table(serve_split_llm.main, argv + ["--device", "cpu"])
    want, _ = _table(_reference_example().main, argv)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        if len(w.split()) == 6 and w.split()[0] in ("bf16", "float32",
                                                     "int8_channel",
                                                     "uint8"):
            assert g.split()[:3] == w.split()[:3]
        else:
            assert g == w
    by = {r["codec"]: r for r in rows}
    assert sorted(by) == ["bf16", "float32", "int8_channel", "uint8"]
    assert by["float32"]["max_dlogit"] == 0.0
    assert by["bf16"]["top1_agree"] == 1.0
    assert by["uint8"]["wire_bytes"] == get_codec("uint8").wire_bytes(
        (2, 16, 256))


def test_serve_split_llm_refuses_the_audio_family():
    from repro_torch.examples import serve_split_llm
    msg = "enc-dec archs use the natural encoder/decoder split"
    for main, argv in ((serve_split_llm.main, ["--device", "cpu"]),
                       (_reference_example().main, [])):
        with pytest.raises(SystemExit, match=msg):
            main(["--arch", "whisper-medium"] + argv)
