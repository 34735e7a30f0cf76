"""The hybrid LM cell (``granite4h.pf4x2048``) on the CPU at a tiny size:
a dry run decides ``correct`` for real; the planted faults and the fp8
control fail its check; the yardstick's arithmetic is the program's."""
import copy
import io
import json

import pytest
import torch

from bench.tests.tiny import ROOT  # noqa: F401  (puts src and the root on the path)
from bench import harness, lm_readings, lm_roofline
from bench.reference import hybrid_lm as ref
from repro_torch.core.split import SplitModel

CELL = "granite4h.pf4x2048"
_edge = SplitModel.edge_step_batch
_server = SplitModel.server_step_batch


def tiny(layers=("mamba", "attention") * 2, edge: int = 2):
    """(bench, cell, config) of the cell at small widths: the published
    config's keys, narrowed; the cell's limits are its own."""
    bench, cell, config = harness.load_cell(CELL)
    cell, config = copy.deepcopy(cell), copy.deepcopy(config)
    config.update(hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=32,
                  shared_intermediate_size=48, num_local_experts=8,
                  num_experts_per_tok=3, vocab_size=256, mamba_d_state=16,
                  mamba_d_head=16, mamba_n_heads=8, mamba_chunk_size=8,
                  layer_types=list(layers), num_hidden_layers=len(layers),
                  edge_layers=edge)
    cell["params"].update(frames_per_tick=2, seq_len=16, warm_ticks=2,
                          check_ticks=3, trace_ticks=3)
    return bench, cell, config


def dry_run(trace: int = 0, seconds: float = 0.2, seed: int = 2**40 + 9):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(CELL, seed, seconds, trace, device="cpu", cells=tiny(),
                     out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, [json.loads(l) for l in lines], err.getvalue()


@pytest.mark.parametrize("trace", [0, 1])
def test_dry_line_has_the_contract_keys(trace):
    rc, (first, line), err = dry_run(trace)
    assert rc == 0
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "checks"} and list(line)[-1] == "checks"
    assert line["correct"] is True, err
    assert line["attempted"] > 0 and line["attempted"] % 2 == 0
    for m in line["metrics"].values():
        assert m["value"] is None and m["note"].startswith("not measured")
    want = ({"setup_s", "decisions_per_s", "decision_ms_p95"} if not trace
            else {"moe_device_ms", "ssm_device_ms", "expert_gemm_roofline",
                  "lm_decision_mfu"})
    assert set(line["metrics"]) == want
    assert set(line["checks"]) == {"hidden_gap", "header_gap", "logit_gap",
                                   "route_flips", "codec_gap"}
    # the program's bf16 rounding moves no route by ROUTE_MARGIN
    assert line["checks"]["route_flips"]["value"] == 0.0
    # the counters on the first line: every (token, k) pair of every layer
    ticks = first["ticks"] + 2 + (13 if trace else 0)
    assert first["moe.routed_rows"] == ticks * 2 * 16 * 3 * 4
    assert 0 < first["moe.max_expert_rows"] <= 32
    assert first["moe_grouped.launches"] == 0       # the CPU's plain version


def stale(monkeypatch):
    """The server returns the previous tick's logits."""
    last = {}

    def server(self, params, payload):
        z = _server(self, params, payload)
        prev = last.get("z", z)
        last["z"] = z
        return prev
    monkeypatch.setattr(SplitModel, "server_step_batch", server)


def altered_code(monkeypatch):
    """One code of one payload moved by 3 where the edge produces it."""
    def edge(self, params, obs):
        p = _edge(self, params, obs)
        c = p["data"].view(-1)
        c[c.numel() // 3] = (c[c.numel() // 3].int() + 3) % 256
        return p
    monkeypatch.setattr(SplitModel, "edge_step_batch", edge)


def altered_answer(monkeypatch):
    """One logit moved where the server produces it."""
    def server(self, params, payload):
        z = _server(self, params, payload).clone()
        z[0, 0, 0] += z.abs().max()
        return z
    monkeypatch.setattr(SplitModel, "server_step_batch", server)


def wrong_expert(monkeypatch):
    """Each expert's rows computed with the previous expert's weights."""
    from repro_torch.nn import moe
    grouped = moe.moe_grouped

    def rolled(x, offsets, g, u, d, **kw):
        return grouped(x, offsets, g.roll(1, 0), u.roll(1, 0),
                       d.roll(1, 0), **kw)
    monkeypatch.setattr(moe, "moe_grouped", rolled)


def misrouted(monkeypatch):
    """The router's logits of every 25th token negated: it picks that
    token's weakest experts."""
    from repro_torch.nn import moe
    dense = moe.dense

    def router(p, x):
        y = dense(p, x).clone()
        y[::25] = -y[::25]
        return y
    monkeypatch.setattr(moe, "dense", router)


@pytest.mark.parametrize("fault", [stale, altered_code, altered_answer,
                                   wrong_expert, misrouted],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    rc, lines, err = dry_run(seed=2**40 + 21)
    assert rc == 0
    assert lines[-1]["correct"] is False, err


def test_router_fault_is_read_by_route_flips(monkeypatch):
    """A router that picks other experts for 2 of a tick's 32 tokens: the
    reference computes the experts the program chose, so ``route_flips``
    is the number that reads it, each such pair trailing the reference's
    order by far more than ``ROUTE_MARGIN``."""
    misrouted(monkeypatch)
    rc, lines, err = dry_run(seed=2**40 + 23)
    flips = lines[-1]["checks"]["route_flips"]
    assert rc == 0 and flips["value"] > flips["limit"], err
    assert flips["value"] >= 0.9 * 2 / 32


@pytest.mark.parametrize("seed", [2**34 + 3, 2**33 + 5])
def test_control_and_planted_faults_fail_and_program_passes(seed):
    _, cell, config = tiny()
    limits = cell["limits"]
    for line in lm_readings.readings(cell, config, [seed], 0.1, 1, "cpu"):
        assert all(line["sound"][k] <= v for k, v in limits.items()), line
        assert any(line["control"][k] > v for k, v in limits.items()), line
        for fault in lm_readings.FAULTS:
            assert any(line[fault][k] > v for k, v in limits.items()), \
                (fault, line)


def test_same_seed_same_inputs():
    _, cell, config = tiny()
    a = ref.make_inputs(config, cell["params"], 2**35 + 1, "cpu")
    b = ref.make_inputs(config, cell["params"], 2**35 + 1, "cpu")
    c = ref.make_inputs(config, cell["params"], 2**35 + 2, "cpu")
    assert a["tokens"].equal(b["tokens"])
    assert a["layers"][3]["w_down"].equal(b["layers"][3]["w_down"])
    assert not a["tokens"].equal(c["tokens"])
    # a layer's weights are views of the stacks the program takes whole
    assert a["layers"][2]["in_proj"].data_ptr() == \
        a["stacks"][0]["in_proj"][1].data_ptr()


def test_reference_ssd_chunks_equal_the_scan():
    g = torch.Generator().manual_seed(3)
    b, S, h, p, n = 2, 32, 3, 4, 5
    x = torch.randn(b, S, h, p, generator=g, dtype=torch.float64)
    dt = torch.rand(b, S, h, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(h, generator=g, dtype=torch.float64) * 4
    B = torch.randn(b, S, h, n, generator=g, dtype=torch.float64)
    C = torch.randn(b, S, h, n, generator=g, dtype=torch.float64)
    for chunk in (4, 8, 32):
        torch.testing.assert_close(ref.ssd(x, dt, A, B, C, chunk),
                                   ref.ssd_scan(x, dt, A, B, C),
                                   rtol=1e-10, atol=1e-10)


def _published_cut():
    _, _, config = harness.load_cell(CELL)
    return config


def test_configuration_file_is_the_published_config_cut_in_depth():
    config = _published_cut()
    assert config["reduced"] == ["num_hidden_layers"]
    assert config["num_hidden_layers"] == 20
    assert len(config["layer_types"]) == 40
    assert (config["hidden_size"], config["intermediate_size"],
            config["num_local_experts"], config["num_experts_per_tok"],
            config["vocab_size"], config["mamba_n_heads"],
            config["shared_intermediate_size"]) == (4096, 768, 72, 10,
                                                   100352, 128, 1536)
    assert ref.period(config) == 10


def test_program_config_is_the_registered_one_cut_in_depth():
    import dataclasses
    from bench.systems.hybrid_lm import arch_config
    from repro_torch.configs import get_config
    cut = arch_config(_published_cut())
    full = get_config("granite-4.0-h-small")
    assert cut.n_layers == 20 and cut.n_pattern == 2
    assert dataclasses.replace(cut, n_layers=40, n_pattern=4) == full


def test_roofline_counts_are_the_programs():
    from bench.systems.hybrid_lm import arch_config
    for config in (_published_cut(), tiny()[2]):
        cfg = arch_config(config)
        assert lm_roofline.param_count(config) == cfg.param_count()
        assert lm_roofline.active_param_count(config) == \
            cfg.active_param_count()
    config = _published_cut()
    cfg = arch_config(config)
    S, D, V = 2048, 4096, 100352
    dense = 2 * S * (cfg.active_param_count() - V * D)
    attn = 2 * 4 * 32 * 128 * S * (S + 1) // 2
    ssm = 18 * 4 * 128 * 64 * 128 * S
    assert lm_roofline.decision_flops(config, S) == \
        dense + attn + ssm + 2 * D * V
    # K7's work a tick: 6 D F a routed pair, 4 x 2,048 tokens x 10 x 20
    rows = lm_roofline.expert_rows(config, 4 * S)
    assert rows == 4 * S * 10 * 20
    assert lm_roofline.expert_flops(config, rows) == 6 * D * 768 * rows


def _trace():
    """A tick holding an ``moe`` span that launches one K7 kernel and an
    ``ssm`` span that launches another kernel, in Chrome's trace format."""
    ann = [("tick", 0, 100), ("edge", 1, 60), ("moe", 10, 40),
           ("moe.experts", 15, 30), ("ssm", 45, 58)]
    ev = [{"cat": "user_annotation", "name": n, "ts": t, "dur": d - t,
           "tid": 1} for n, t, d in ann]
    for corr, (name, launch, start, dur) in enumerate((
            ("void (anonymous namespace)::moe_grouped_kernel<true>(x)", 20,
             30, 25), ("ssd_einsum", 50, 60, 10))):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": launch, "dur": 1, "args": {"correlation": corr}})
        ev.append({"cat": "kernel", "name": name, "ts": start, "dur": dur,
                   "args": {"correlation": corr, "stream": 7}})
    return ev


def test_spans_traffic_reduces_the_programs_spans():
    from bench import trace as trace_mod
    from bench.traffic import closed_ticks_spans as kind
    red = kind.reduce(_trace())
    assert red["ticks"] == 1
    assert red["device_ms"]["moe"] == pytest.approx(0.025)
    assert red["device_ms"]["moe.experts"] == pytest.approx(0.025)
    assert red["device_ms"]["ssm"] == pytest.approx(0.010)
    assert kind.reduce([]) == {}
    rec = {"spans": red, "trace": trace_mod.reduce(_trace()),
           "device_kind": "NVIDIA H100 80GB HBM3", "units": 8,
           "units_per_tick": 4, "window_s": 2.0, "config": _published_cut(),
           "cell": harness.load_cell(CELL)[1]}
    assert harness.load_reader("moe_device_ms").read(rec) == \
        pytest.approx(0.025)
    assert harness.load_reader("ssm_device_ms").read(rec) == \
        pytest.approx(0.010)
    bound = lm_roofline.expert_bound_s(rec["config"], 4 * 2048,
                                       rec["device_kind"])
    assert harness.load_reader("expert_gemm_roofline").read(rec) == \
        pytest.approx(bound / 25e-6 * 100)
    mfu = harness.load_reader("lm_decision_mfu").read(rec)
    assert mfu == pytest.approx(lm_roofline.decision_flops(
        rec["config"], 2048) * 4 / 989e12 * 100)
    # the parent's record has no spans and no K7: the new readers are silent
    bare = {"trace": {"ops": [], "ticks": 0}, "device_kind": "x"}
    for name in ("moe_device_ms", "ssm_device_ms", "expert_gemm_roofline",
                 "lm_decision_mfu"):
        assert harness.load_reader(name).read(dict(bare)) is None


def test_miniconv_cells_build_only_their_encoder():
    """The MiniConv cells' set-up compiles K1/K4's library alone: K7 and K5
    are built by the hybrid LM system only."""
    import re
    calls = {name: re.findall(r"_build\.build\((\[[^\]]*\])\)",
                              (ROOT / "bench" / "systems" / f"{name}.py")
                              .read_text())
             for name in ("miniconv", "hybrid_lm")}
    assert calls["miniconv"] == ['["miniconv_encoder"]']
    assert calls["hybrid_lm"] == ['["flash_attention", "moe_grouped"]']
