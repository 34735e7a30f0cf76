"""Every file BENCHMARK.json names is where the harness looks for it, and
the file keeps the contract's shape."""
import json
import re

import pytest

from bench.tests.tiny import ROOT
from bench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_is_found(name):
    c = next(c for c in BENCH["configs"] if c["name"] == name)
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    path = ROOT / c["file"]
    assert path.is_file() and c["file"].startswith("bench/configs/")
    cfg = json.loads(path.read_text())
    assert cfg["name"] == name and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                           for k in c["reduced"])
    assert (ROOT / "bench" / "systems" / f"{cfg['family']}.py").is_file()
    assert (ROOT / "bench" / "reference" / f"{cfg['family']}.py").is_file()
    assert any(w["config"] == name for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_file_is_found_and_agrees(name):
    _, cell, config = harness.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["why"] == cell["why"] and len(cell["why"]) <= 200
    assert entry["chips"] == cell["chips"] and entry["chips"] in (1, 4)
    assert (ROOT / "bench" / "traffic" / f"{cell['kind']}.py").is_file()
    assert cell["limits"] and all(isinstance(v, (int, float))
                                  for v in cell["limits"].values())
    e2e = [m["name"] for m in harness.metric_entries(BENCH, name,
                                                     "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metric_entries(BENCH, name, "per_layer")


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_readers_are_found(kind):
    for m in BENCH[kind]:
        reader = harness.load_reader(m["name"])
        assert reader.UNIT == m["unit"] and callable(reader.read)
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
            assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("key", ["dtype", "tf32", "frames_per_tick",
                                 "reference_block"])
def test_harness_reads_no_family_key(key):
    """Precision, batch and the reference's block are the family's and the
    traffic kind's to read, so a later family needs no edit here."""
    assert key not in (ROOT / "bench" / "harness.py").read_text()


def test_miniconv_system_sets_its_own_precision():
    import torch
    from bench.systems import miniconv
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    try:
        with pytest.raises(ValueError):
            miniconv.set_precision({"name": "x", "dtype": "bfloat16"})
        for c in BENCH["configs"]:
            cfg = json.loads((ROOT / c["file"]).read_text())
            if cfg["family"] == "miniconv":
                miniconv.set_precision(cfg)
                assert torch.backends.cuda.matmul.allow_tf32 is cfg["tf32"]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
