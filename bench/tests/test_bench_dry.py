"""A dry run on the CPU at a tiny size: the result line has exactly the
contract's keys, its metrics are marked not measured, and the command
refuses to run without a card."""
import os
import subprocess
import sys

import pytest

from bench.tests.tiny import CELLS, ROOT, dry_run

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_dry_line_has_the_contract_keys(name, trace):
    rc, line, err = dry_run(name, trace=trace)
    assert rc == 0
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0 and line["attempted"] % 4 == 0
    assert line["device"]["platform"] == "cpu"
    for m in line["metrics"].values():
        assert m["value"] is None and m["note"].startswith("not measured")
    want = {"setup_s", "decisions_per_s", "decision_ms_p95"} if not trace \
        else {"host_ms_per_tick", "edge_device_ms", "encoder_roofline",
              "server_device_ms", "device_idle", "kernels_per_tick",
              "decision_mfu"}
    assert set(line["metrics"]) == want
    tail = err.strip().splitlines()[-3:]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_command_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "mc84.envs256", "--seed", str(2**33),
                        "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA device" in r.stderr


def test_same_seed_same_inputs():
    from bench.reference import miniconv as ref
    from bench.tests.tiny import tiny
    _, cell, config = tiny("mc84.envs256")
    a = ref.make_inputs(config, cell["params"], 2**35 + 1, "cpu")
    b = ref.make_inputs(config, cell["params"], 2**35 + 1, "cpu")
    c = ref.make_inputs(config, cell["params"], 2**35 + 2, "cpu")
    assert a["frames"].equal(b["frames"])
    assert a["proj"][0].equal(b["proj"][0])
    assert not a["frames"].equal(c["frames"])
