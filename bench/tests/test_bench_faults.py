"""The rest of a run, with the timed path broken underneath the harness:
each fault this kind of cell can have turns ``correct`` false.  (There is
no exchange between chips in a one-chip cell.)"""
import pytest
import torch

from bench.tests.tiny import CELLS, dry_run
from repro_torch.core.split import SplitModel

_edge = SplitModel.edge_step_batch
_server = SplitModel.server_step_batch


def stale(monkeypatch):
    """The server returns the previous tick's outputs."""
    last = {}

    def server(self, params, payload):
        z = _server(self, params, payload)
        prev = last.get("z", z)
        last["z"] = z
        return prev
    monkeypatch.setattr(SplitModel, "server_step_batch", server)


def half_batch(monkeypatch):
    """The edge encodes the first half of the batch and serves it twice."""
    def edge(self, params, obs):
        h = obs.shape[0] // 2
        p = _edge(self, params, obs[:h])
        return {k: torch.cat([v, v]) for k, v in p.items()}
    monkeypatch.setattr(SplitModel, "edge_step_batch", edge)


def altered_code(monkeypatch):
    """One code of one payload moved by 3 where the edge produces it."""
    def edge(self, params, obs):
        p = _edge(self, params, obs)
        c = p["data"].view(-1)
        c[c.numel() // 3] = (c[c.numel() // 3].int() + 3) % 256
        return p
    monkeypatch.setattr(SplitModel, "edge_step_batch", edge)


def altered_answer(monkeypatch):
    """One served output moved where the server produces it."""
    def server(self, params, payload):
        z = _server(self, params, payload).clone()
        z[0, 0] += z.abs().max()
        return z
    monkeypatch.setattr(SplitModel, "server_step_batch", server)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    rc, line, _ = dry_run(name)
    assert rc == 0 and line["correct"] is True


@pytest.mark.parametrize("fault", [stale, half_batch, altered_code,
                                   altered_answer],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    rc, line, err = dry_run(name)
    assert rc == 0
    assert line["correct"] is False, err
