"""The MLA LM cell (``moonlight.pf2x8192``) on the CPU at a tiny size: a dry
run decides ``correct`` for real; the planted faults (the router's among
them) and the fp8 control fail its check; the yardstick's arithmetic is
the program's."""
import copy
import io
import json

import pytest
import torch

from bench.tests.tiny import ROOT  # noqa: F401  (puts src and the root on the path)
from bench import harness, mla_readings, mla_roofline
from bench.reference import mla_lm as ref
from repro_torch.core.split import SplitModel

CELL = "moonlight.pf2x8192"
_edge = SplitModel.edge_step_batch
_server = SplitModel.server_step_batch
LAYERS, EDGE, PROMPTS, SEQ, TOPK = 4, 2, 2, 16, 2


def tiny():
    """(bench, cell, config) of the cell at small widths: the published
    config's keys, narrowed; the cell's limits are its own."""
    bench, cell, config = harness.load_cell(CELL)
    cell, config = copy.deepcopy(cell), copy.deepcopy(config)
    config.update(hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=4, kv_lora_rank=32,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                  intermediate_size=96, moe_intermediate_size=32,
                  n_routed_experts=8, num_experts_per_tok=TOPK,
                  vocab_size=256, num_hidden_layers=LAYERS,
                  edge_layers=EDGE)
    cell["params"].update(frames_per_tick=PROMPTS, seq_len=SEQ,
                          warm_ticks=2, check_ticks=3, trace_ticks=3)
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
    assert line["attempted"] > 0 and line["attempted"] % PROMPTS == 0
    for m in line["metrics"].values():
        assert m["value"] is None and m["note"].startswith("not measured")
    want = ({"setup_s", "decisions_per_s", "decision_ms_p95"} if not trace
            else {"mla_device_ms", "mla_attn_roofline", "mla_decision_mfu"})
    assert set(line["metrics"]) == want
    assert set(line["checks"]) == {"hidden_gap", "header_gap", "logit_gap",
                                   "route_flips", "codec_gap"}
    # the program's bf16 rounding moves no route by ROUTE_MARGIN
    assert line["checks"]["route_flips"]["value"] == 0.0
    # every (token, k) pair of every MoE layer, the dense lead layer none
    ticks = first["ticks"] + 2 + (13 if trace else 0)
    assert first["moe.routed_rows"] == \
        ticks * PROMPTS * SEQ * TOPK * (LAYERS - 1)
    assert 0 < first["moe.max_expert_rows"] <= PROMPTS * SEQ
    # the CPU's plain versions launch nothing; prefill reads no cache
    assert first["moe_grouped.launches"] == 0
    assert first["flash_attention.launches"] == 0
    assert first["mla.cache_bytes"] == 0


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


def no_bias(monkeypatch):
    """The router chooses on the sigmoid scores alone, the correction bias
    ignored."""
    from repro_torch.nn import moe
    route = moe._route

    def faulty(params, cfg, logits):
        zero = torch.zeros_like(params["e_score_correction_bias"])
        return route({**params, "e_score_correction_bias": zero}, cfg,
                     logits)
    monkeypatch.setattr(moe, "_route", faulty)


def no_scale(monkeypatch):
    """The gates not multiplied by routed_scaling_factor (2.446)."""
    from repro_torch.nn import moe
    route = moe._route

    def faulty(params, cfg, logits):
        idx, gates = route(params, cfg, logits)
        return idx, gates / cfg.routed_scaling
    monkeypatch.setattr(moe, "_route", faulty)


def no_rope(monkeypatch):
    """RoPE left out of the queries' and keys' rotary parts."""
    from repro_torch.nn import mla
    monkeypatch.setattr(mla, "_rope", lambda cfg, x, positions: x)


@pytest.mark.parametrize("fault", [stale, altered_code, altered_answer,
                                   wrong_expert, no_bias, no_scale, no_rope],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    rc, lines, err = dry_run(seed=2**40 + 21)
    assert rc == 0
    assert lines[-1]["correct"] is False, err


@pytest.mark.parametrize("fault,reads", [(no_bias, "route_flips"),
                                         (no_scale, "logit_gap")],
                         ids=["no_bias", "no_scale"])
def test_router_faults_are_read(fault, reads, monkeypatch):
    """The reference computes the experts the program chose, so a router
    that ignores the bias shows in ``route_flips`` alone; one that drops
    the routed scale moves the logits (and the boundary hidden) by a good
    part of their size."""
    fault(monkeypatch)
    rc, lines, err = dry_run(seed=2**40 + 23)
    check = lines[-1]["checks"][reads]
    assert rc == 0 and check["value"] > check["limit"], err


@pytest.mark.parametrize("seed", [2**34 + 3, 2**33 + 5])
def test_control_and_planted_faults_fail_and_program_passes(seed):
    _, cell, config = tiny()
    limits = cell["limits"]
    for line in mla_readings.readings(cell, config, [seed], 0.1, 1, "cpu"):
        assert all(line["sound"][k] <= v for k, v in limits.items()), line
        assert any(line["control"][k] > v for k, v in limits.items()), line
        for fault in mla_readings.FAULTS + mla_readings.ROUTER_FAULTS:
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
    # an MoE layer's weights are views of the stack the program takes whole
    assert a["layers"][2]["wq"].data_ptr() == a["stack"]["wq"][1].data_ptr()
    assert "gate" in a["layers"][0] and "router" not in a["layers"][0]
    # the correction bias is drawn, at its stated scale
    bias = a["stack"]["bias"]
    assert bias.dtype == torch.float32 and bias.abs().min() > 0
    assert 0.5 * ref.BIAS_STD < bias.std() < 2 * ref.BIAS_STD


def _published():
    return harness.load_cell(CELL)[2]


def test_configuration_file_holds_the_catalog_entry_uncut():
    config = _published()
    assert config["reduced"] == [] and config["family"] == "mla_lm"
    assert (config["hidden_size"], config["num_hidden_layers"],
            config["kv_lora_rank"], config["qk_nope_head_dim"],
            config["qk_rope_head_dim"], config["v_head_dim"],
            config["n_routed_experts"], config["num_experts_per_tok"],
            config["moe_intermediate_size"], config["intermediate_size"],
            config["vocab_size"], config["routed_scaling_factor"]) == (
        2048, 27, 512, 128, 64, 128, 64, 6, 1408, 11264, 163840, 2.446)
    assert config["edge_layers"] == 13 and config["dtype"] == "bfloat16"


def test_roofline_counts_are_the_programs():
    from bench.systems.mla_lm import arch_config
    for config in (_published(), tiny()[2]):
        cfg = arch_config(config)
        assert mla_roofline.param_count(config) == cfg.param_count()
        assert mla_roofline.active_param_count(config) == \
            cfg.active_param_count()
    config = _published()
    cfg = arch_config(config)
    S, D, V = 8192, 2048, 163840
    core = 27 * 2 * 16 * (192 + 128) * S * (S + 1) // 2
    assert mla_roofline.core_flops(config, S) == core
    flops = mla_roofline.decision_flops(config, S)
    assert flops == 2 * S * (cfg.active_param_count() - 2 * V * D) + core \
        + 2 * D * V
    assert 45.9e12 < flops < 46.1e12            # 46.0 TFLOP a decision
    # the cores of a tick: 2 prompts, bound by operations at 18.8 ms
    bound = mla_roofline.core_bound_s(config, S, 2, "NVIDIA H100 80GB HBM3")
    assert bound == pytest.approx(2 * core / 989e12)
    assert 18.7e-3 < bound < 18.9e-3
    assert mla_roofline.core_bound_s(config, S, 2, "x") is None


def _trace():
    """A tick holding an ``mla`` span whose ``mla.core`` launches one K5
    kernel, and an ``moe`` span that launches another kernel, in Chrome's
    trace format."""
    ann = [("tick", 0, 100), ("edge", 1, 60), ("mla", 10, 40),
           ("mla.core", 15, 30), ("moe", 45, 58)]
    ev = [{"cat": "user_annotation", "name": n, "ts": t, "dur": d - t,
           "tid": 1} for n, t, d in ann]
    for corr, (name, launch, start, dur) in enumerate((
            ("void (anonymous namespace)::tc::flash_kernel_tc<2, 192, 128>"
             "(x)", 20, 30, 25), ("moe_grouped_kernel<true>", 50, 60, 10))):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": launch, "dur": 1, "args": {"correlation": corr}})
        ev.append({"cat": "kernel", "name": name, "ts": start, "dur": dur,
                   "args": {"correlation": corr, "stream": 7}})
    return ev


def test_mla_traffic_reduces_the_programs_spans_and_readers_read_them():
    from bench import trace as trace_mod
    from bench.traffic import closed_ticks_mla as kind
    red = kind.reduce(_trace())
    assert red["ticks"] == 1
    assert red["device_ms"]["mla"] == pytest.approx(0.025)
    assert red["device_ms"]["mla.core"] == pytest.approx(0.025)
    assert red["device_ms"]["moe"] == pytest.approx(0.010)
    assert kind.reduce([]) == {}
    rec = {"spans": red, "trace": trace_mod.reduce(_trace()),
           "device_kind": "NVIDIA H100 80GB HBM3", "units": 8,
           "units_per_tick": 2, "window_s": 2.0, "config": _published(),
           "cell": harness.load_cell(CELL)[1]}
    assert harness.load_reader("mla_device_ms").read(rec) == \
        pytest.approx(0.025)
    bound = mla_roofline.core_bound_s(rec["config"], 8192, 2,
                                      rec["device_kind"])
    assert harness.load_reader("mla_attn_roofline").read(rec) == \
        pytest.approx(bound / 25e-6 * 100)
    mfu = harness.load_reader("mla_decision_mfu").read(rec)
    assert mfu == pytest.approx(mla_roofline.decision_flops(
        rec["config"], 8192) * 4 / 989e12 * 100)
    # the parent's record has no spans and no K5: the new readers are silent
    bare = {"trace": {"ops": [], "ticks": 0}, "device_kind": "x"}
    for name in ("mla_device_ms", "mla_attn_roofline", "mla_decision_mfu"):
        assert harness.load_reader(name).read(dict(bare)) is None


def test_mla_system_builds_its_kernels_alone():
    """The MLA system compiles K5's, K7's and K9's libraries at set-up."""
    import re
    text = (ROOT / "bench" / "systems" / "mla_lm.py").read_text()
    assert re.findall(r"_build\.build\((\[[^\]]*\])\)", text) == [
        '["flash_attention", "moe_grouped", "moe_combine"]']
