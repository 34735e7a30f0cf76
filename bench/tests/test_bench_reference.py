"""The plain reference agrees with the port's CPU path (the kernels'
plain versions) on 2 frames of each configuration at its full size."""
import pytest
import torch

from bench.tests.tiny import CELLS
from bench import harness
from bench.reference import miniconv as ref
from bench.systems import miniconv as system


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    _, cell, config = harness.load_cell(name)
    params = dict(cell["params"], frames_per_tick=2, pool_batches=1)
    cell = dict(cell, params=params)
    inputs = ref.make_inputs(config, params, 2**33 + 5, "cpu")
    s = system.System(config, cell, "cpu")
    s.bind(inputs)
    s.dispatch(0)
    s.wait()
    sample = s.keep()
    frames = inputs["frames"][0]
    want = ref.encode(config, inputs, frames)
    got = s.dep.split.edge_apply(s.edge_params, frames)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    gaps = ref.gaps(config, inputs, sample, want)
    assert gaps["feature_gap"] < 1e-3 and gaps["header_gap"] < 1e-3
    assert gaps["server_gap"] < 1e-6
    whole = ref.decide(config, inputs, frames)
    assert (whole["codes"].int() - sample["codes"].int()).abs().max() <= 1
    torch.testing.assert_close(sample["z"], whole["z"], rtol=1e-4,
                               atol=1e-4)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -1 - 2**-12,
                      1 + 2**-10, 3.0e-3], dtype=torch.float32)
    got = ref.to_tf32(x)
    assert got[0] == 1.0 and got[4] == 1 + 2**-10
    assert got[1] == 1.0                     # a tie goes to even
    assert got[2] == 1 + 2**-9               # a tie goes to even
    assert got[3] == -1.0
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((got - x).abs() <= x.abs() * 2**-11).all()


def test_same_pads():
    assert ref.same_pads(84, 4, 2) == (1, 1)
    assert ref.same_pads(42, 3, 2) == (0, 1)
    assert ref.same_pads(21, 3, 2) == (1, 1)
    assert ref.same_pads(400, 4, 2) == (1, 1)
