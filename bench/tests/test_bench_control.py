"""The control, the reference put in the program's place and computed
with TF32 operands, fails each cell's check at a size a test run holds;
the program's readings pass it.  On the chip, ``bench/readings.py`` takes
the same readings at the cells' own sizes."""
import pytest

from bench.tests.tiny import CELLS, tiny
from bench import readings


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    _, cell, config = tiny(name)
    limits = cell["limits"]
    for line in readings.readings(cell, config, [2**34 + 3], 0.1, 1,
                                  "cpu"):
        assert all(line["sound"][k] <= v for k, v in limits.items())
        assert any(line["control"][k] > v for k, v in limits.items())
        for fault in ("stale", "half_batch", "altered_code"):
            assert any(line[fault][k] > v for k, v in limits.items())


def test_plant_leaves_the_answers_it_is_given():
    import torch
    s = {"codes": torch.arange(8, dtype=torch.uint8).view(4, 2),
         "scale": torch.ones(4), "zero": torch.zeros(4),
         "z": torch.ones(4, 3)}
    kept = [(0, s), (1, {k: v + 1 for k, v in s.items()})]
    for fault in ("stale", "half_batch", "altered_code"):
        out = readings.plant(fault, kept)
        assert len(out) == 2 and kept[0][1]["codes"].equal(s["codes"])
        assert any(not out[i][1]["codes"].equal(kept[i][1]["codes"])
                   for i in range(2))
