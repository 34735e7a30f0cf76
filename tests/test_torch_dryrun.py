"""The port's dry-run on the CPU: the cost counter against hand counts and
against the reference's HLO walk, K5's ``meta`` branch, the roofline
terms against the reference's, depth extrapolation against whole
traces, and ``dryrun.run_one`` on both fake production meshes, its rows
rendered by ``roofline_table``.

The fake process group (512 ranks) lives for this module and is
destroyed after it.  Exact: FLOPs and bytes against hand counts;
``model_flops``, ``hbm_floor_bytes``, ``to_dict``, ``fmt_row`` and
``HEADER`` against the reference's with its peaks set to the H100's;
``PAIRS``; extrapolated counts against a whole trace.  Against the
reference's ``analyse_hlo`` of a reduced f32 prefill the port counts
exactly the dots the reference's HLO holds, less the two it does not
compute: the masked half of each causal score matrix (K5 records only
the pairs it scores) and the logits of the first S - 1 positions (the
head runs on the last one); the remainder agrees within 1e-9.
"""
import contextlib
import dataclasses
import io
import json
import math

import pytest

pytest.importorskip("torch")

import torch

from repro import configs as j_configs
from repro.launch import perf as j_perf
from repro.launch import roofline as j_roofline
from repro.launch import steps as j_steps
from repro.launch.hlo_analysis import analyse_hlo
from repro.launch.mesh import make_host_mesh as j_host_mesh

from repro_torch.benchmarks import roofline_table
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import dryrun, perf, roofline, steps
from repro_torch.costs import CostCounter, attention_flops, record
from repro_torch.launch.mesh import (destroy, init_fake_group,
                                     make_production_mesh)
from repro_torch.models.config import ShapeConfig

torch.set_num_threads(1)

ARCH = "qwen3-0.6b"


@pytest.fixture(scope="module", autouse=True)
def fake_group():
    init_fake_group(512)
    yield
    destroy()


def _reduced_overrides(arch=ARCH):
    cfg = get_config(arch)
    red = cfg.reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(cfg, f.name)}


OV = _reduced_overrides()


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def test_counter_flops_and_bytes_match_hand_counts():
    a, b = torch.ones(8, 16), torch.ones(16, 32)
    x, y = torch.ones(4, 8, 16), torch.ones(4, 16, 2)
    img, ker = torch.ones(1, 3, 10, 10), torch.ones(5, 3, 3, 3)
    with CostCounter() as c:
        a @ b                                   # mm
        torch.bmm(x, y)                         # bmm
        torch.einsum("bij,bjk->bik", x, y)      # a bmm after views
        torch.nn.functional.conv2d(img, ker)    # 8x8 output
    conv = 2 * (5 * 8 * 8) * (3 * 3 * 3)
    assert c.flops == 2 * 8 * 16 * 32 + 2 * (2 * 4 * 8 * 16 * 2) + conv
    n = 1000
    u, v = torch.ones(n), torch.ones(n)
    with CostCounter() as c:
        u + v                                   # pointwise: 3 n floats
        u.view(10, 100).t()                     # views move nothing
        torch.empty(n)                          # nor allocations
        u.add_(v)                               # read u, v; write u
        a @ b
    mm = (8 * 16 + 16 * 32 + 8 * 32) * 4
    assert c.bytes_accessed == 3 * n * 4 + 3 * n * 4 + mm
    assert c.bytes_fused == mm                  # pointwise ops fuse away
    assert c.flops == 2 * 8 * 16 * 32 and c.ops == 3


def test_counter_counts_an_indexed_write_by_its_rows():
    cache, row = torch.zeros(2, 64, 4, 8), torch.ones(2, 1, 4, 8)
    idx = torch.tensor([3])
    with CostCounter() as c:
        cache.index_copy_(1, idx, row)
    assert c.bytes_accessed == 2 * row.numel() * 4 + idx.numel() * 8


def test_counter_peak_is_the_live_local_storage():
    with CostCounter() as c:
        x = torch.ones(1000)                    # 4 kB
        y = x * 2                               # 8 kB alive
        del x
        z = y + 1                               # 8 kB: x was freed
        del y, z
        w = torch.ones(3000)                    # 12 kB
    assert c.peak_bytes == 12000 and c.live_bytes == 12000
    del w


def test_counter_filters_by_device_and_records_outside_work():
    with CostCounter("meta") as c:
        torch.ones(4, 4) @ torch.ones(4, 4)     # CPU: not this device
        torch.empty(4, 4, device="meta") @ torch.empty(4, 4, device="meta")
        record(10, 20)
    assert c.flops == 2 * 4 * 4 * 4 + 10 and c.bytes_accessed == \
        3 * 64 + 20 and c.bytes_fused == 3 * 64 + 20


def test_k5_meta_branch_records_its_work_and_launches_nothing():
    B, H, H_kv, S, D = 1, 16, 8, 256, 128
    q = torch.empty(B, S, H, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, S, H_kv, D, dtype=torch.bfloat16, device="meta")
    before = flash_attention.launches
    with CostCounter("meta") as c:
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            k.transpose(1, 2), causal=True)
    assert flash_attention.launches == before
    assert o.shape == (B, H, S, D) and o.dtype == torch.bfloat16
    assert o.device.type == "meta"
    assert c.flops == 4 * B * H * D * S * (S + 1) // 2
    assert c.bytes_accessed == (2 * B * H + 2 * B * H_kv) * S * D * 2
    assert attention_flops(1, 1, 8, 8, 1, causal=True, window=3) == \
        4 * (1 + 2 + 3 * 6)
    assert attention_flops(1, 1, 8, 8, 1, causal=False) == 4 * 64


def test_counter_matches_the_reference_hlo_walk_on_a_prefill(monkeypatch):
    B, S = 2, 64
    shape = ShapeConfig("prefill_32k", S, B, "prefill")
    monkeypatch.setitem(j_configs.SHAPES, "prefill_32k",
                        j_configs.SHAPES["prefill_32k"].__class__(
                            "prefill_32k", S, B, "prefill"))
    jb = j_steps.make_step(ARCH, "prefill_32k",
                           j_host_mesh((1, 1), ("data", "model")),
                           overrides=OV)
    ref = analyse_hlo(jb.lower(j_host_mesh((1, 1), ("data", "model")))
                      .compile().as_text()).flops
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))
    got = steps.trace_step(ARCH, "prefill_32k", mesh, overrides=OV,
                           shape=shape).counter.flops
    cfg = get_config(ARCH).reduced()
    H, D, L = cfg.n_heads, cfg.head_dim, cfg.n_layers
    masked = L * (4 * B * H * D * S * S
                  - attention_flops(B, H, S, S, D, causal=True))
    head = 2 * B * (S - 1) * cfg.d_model * cfg.vocab
    assert abs(got + masked + head - ref) / ref < 1e-9, (got, ref)


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

def test_roofline_formulas_equal_the_reference(monkeypatch):
    for arch in sorted(j_configs.ARCHS):  # the port's own have no reference
        for sid, shape in SHAPES.items():
            jcfg, jshape = j_configs.get_config(arch), j_configs.SHAPES[sid]
            cfg = get_config(arch)
            assert roofline.model_flops(cfg, shape) == \
                j_roofline.model_flops(jcfg, jshape)
            for chips in (256, 512):
                assert roofline.hbm_floor_bytes(cfg, shape, chips) == \
                    j_roofline.hbm_floor_bytes(jcfg, jshape, chips)
    for name, value in (("PEAK_FLOPS", roofline.PEAK_FLOPS),
                        ("HBM_BW", roofline.HBM_BW),
                        ("ICI_BW", roofline.LINK_BW)):
        monkeypatch.setattr(j_roofline, name, value)
    kw = dict(arch=ARCH, shape="train_4k", mesh="single", chips=256,
              flops_per_chip=1.5e13, bytes_per_chip=2.5e11,
              coll_bytes_per_chip=3.5e9,
              coll_breakdown={k: 7 for k in j_roofline.COLLECTIVE_OPS},
              model_flops=9.5e14, bytes_upper_per_chip=4e11,
              bytes_floor_per_chip=1e11, peak_memory_bytes=3 * 2 ** 30)
    r, jr = roofline.Roofline(**kw), j_roofline.Roofline(**kw)
    assert r.to_dict() == jr.to_dict()
    assert roofline.fmt_row(r) == j_roofline.fmt_row(jr)
    assert roofline.HEADER == j_roofline.HEADER
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)


def test_perf_pairs_equal_the_reference():
    assert perf.PAIRS == j_perf.PAIRS


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

WIDE = {**OV, "n_heads": 16, "n_kv_heads": 8, "head_dim": 16,
        "n_layers": 4, "n_pattern": 4}


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_extrapolated_counts_equal_a_whole_trace(kind):
    """Past two blocks every block adds the same counts: the depth-2/3
    extrapolation to 4 blocks equals the whole 4-block trace, peak
    included (a 16x16 fake mesh, so the collectives count too)."""
    sid = {"train": "train_4k", "decode": "decode_32k"}[kind]
    shape = ShapeConfig(sid, 32, 32, kind)
    mesh = make_production_mesh()
    whole = steps.trace_step(ARCH, sid, mesh, overrides=WIDE, shape=shape,
                             extrapolate=False).counter
    ext = steps.trace_step(ARCH, sid, mesh, overrides=WIDE,
                           shape=shape).counter
    assert ext == whole
    assert whole.flops > 0 and sum(whole.coll_breakdown.values()) > 0


def test_trace_allocates_nothing_and_launches_nothing():
    mesh = make_production_mesh()
    bundle = steps.make_step(ARCH, "prefill_32k", mesh, overrides=OV,
                             shape=ShapeConfig("prefill_32k", 64, 32,
                                               "prefill"))
    before = flash_attention.launches
    traced = bundle.trace(mesh)
    assert flash_attention.launches == before
    out = traced.outputs
    assert out.shape == (32, get_config(ARCH).reduced().vocab)
    assert out.to_local().device.type == "meta"
    assert traced.counter.flops > 0 and traced.counter.peak_bytes > 0


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_run_one_rows_render_in_the_roofline_table(mesh_name, tmp_path,
                                                   capsys):
    rows = []
    for sid in ("prefill_32k", "decode_32k"):
        d = dryrun.run_one(ARCH, sid, mesh_name, overrides=OV)
        assert d["mesh"] == mesh_name and d["chips"] == (
            256 if mesh_name == "single" else 512)
        assert d["trace_s"] > 0 and d["flops_per_chip"] > 0
        assert d["torch"] == torch.__version__
        assert set(roofline.Roofline(**{
            k: d[k] for k in ("arch", "shape", "mesh", "chips",
                              "flops_per_chip", "bytes_per_chip",
                              "coll_bytes_per_chip", "coll_breakdown",
                              "model_flops")}).to_dict()) <= set(d)
        rows.append(d)
    out = capsys.readouterr().out
    assert out.count(f"mesh={mesh_name}]") == 2
    path = tmp_path / "dryrun_rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        roofline_table.main(["--glob", str(path), "--all"])
    lines = buf.getvalue().splitlines()
    assert lines[0] == roofline_table.HEADER and len(lines) == 3
    assert all(ARCH in line and mesh_name in line for line in lines[1:])


def test_ssm_prefill_on_dtensors_takes_the_plain_scan(monkeypatch):
    """A Mamba-2 prefill over ``meta`` DTensors: ``nn.ssm`` sends DTensors
    to the plain scan, whose einsums the counter sees chip by chip, and
    never to K8, which would record the global shapes' work as one
    chip's."""
    from repro_torch.nn import ssm

    def refuse(*args, **kwargs):
        raise AssertionError("K8 was handed DTensors")

    monkeypatch.setattr(ssm, "ssd_scan", refuse)
    d = dryrun.run_one("mamba2-130m", "prefill_32k", "single",
                       verbose=False)
    assert d["flops_per_chip"] > 0 and d["bytes_per_chip"] > 0


def test_dryrun_cli_prints_the_header_and_a_row(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    argv = ["--arch", ARCH, "--shape", "decode_32k", "--mesh", "single",
            "--out", str(out)]
    for k, v in OV.items():
        argv += ["--override", f"{k}={v}"]
    assert dryrun.main(argv) == 0
    text = capsys.readouterr().out
    assert text.splitlines()[0] == roofline.HEADER
    assert "all dry-runs traced OK" in text
    (row,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert row["shape"] == "decode_32k" and "error" not in row
    assert row["overrides"]["d_model"] == "256"
    assert dryrun.parse_overrides(["a=true", "b=4", "c=tp_only"]) == {
        "a": True, "b": 4, "c": "tp_only"}


def test_make_production_mesh_refuses_a_real_group():
    from torch.distributed.device_mesh import DeviceMesh
    mesh = make_production_mesh(multi_pod=True)
    assert isinstance(mesh, DeviceMesh) and tuple(mesh.shape) == (2, 16, 16)
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    with pytest.raises(RuntimeError, match="fake group of 256"):
        init_fake_group(256)
    assert math.prod(make_production_mesh().shape) == 256
