"""The yardstick's frozen arithmetic equals the program's today."""
import pytest

from bench.tests.tiny import CELLS
from bench import harness, roofline

# encoder and projection operations a frame (the issue's table)
WANT = {"mc84.envs256": (13_009_536, 495_616),
        "mc400.cam64": (130_880_000, 10_240_000)}


@pytest.mark.parametrize("name", CELLS)
def test_flops_equal_the_pass_plan(name):
    from repro_torch.deploy import DeploymentConfig
    _, cell, config = harness.load_cell(name)
    m = config["manifest"]
    plan = DeploymentConfig.standard(k=m["k"], c_in=m["c_in"],
                                     h=m["h"]).spec.plan(m["h"])
    enc, proj = roofline.encoder_flops(config), \
        roofline.projection_flops(config)
    assert (enc, proj) == WANT[name]
    assert enc == plan.flops_per_frame
    assert proj == plan.head(m["head_dim"]).flops
    assert roofline.feature_count(config) == plan.flat_features


@pytest.mark.parametrize("name", CELLS)
def test_encoder_bound(name):
    _, cell, config = harness.load_cell(name)
    b = cell["params"]["frames_per_tick"]
    kind = "NVIDIA H100 80GB HBM3"
    bound = roofline.encoder_bound_s(config, b, kind)
    flops_s = b * roofline.encoder_flops(config) / 67e12
    bytes_s = roofline.encoder_bytes(config, b) / 3.35e12
    assert bound == max(flops_s, bytes_s) == flops_s   # both compute-bound
    assert roofline.encoder_bound_s(config, b, "some other card") is None
