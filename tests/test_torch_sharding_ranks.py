"""The sharded steps on a real 2x2 ("data", "model") mesh: four gloo
processes on the CPU, each running its own shard, held against the
unsharded port at the same parameters.

Every other sharded test runs on a 1x1 mesh, where every rank is 0,
every split is whole and no collective moves data.  Here each step runs
on four ranks: the reduced Qwen3 train, prefill and decode steps (decode
with the batch over "data", and at B = 1 with the KV cache's sequence
over "data"), and the reduced MoE train step with and without
``moe_expert_parallel``, with expert widths that the model axis divides
and that it does not (the shared expert then added by model rank 0
alone), and with a batch too small to split.  Each case's loss, logits,
caches and every gradient leaf (the train step runs ``sgd(1.0)``, whose
state after one step is the gradient) must lie within ``TOL`` of the
unsharded port, relative to the largest magnitude of the same tensor;
the sums run in other orders on four ranks, so the match is not bitwise
(at most 1.7e-06 seen on the CPU).  Ranks 1-3 run the same cases for
their shards; rank 0 gathers each result and writes the errors.
"""
import dataclasses
import faulthandler
import json
import socket

import numpy as np
import pytest

pytest.importorskip("torch")

import torch
import torch.distributed as dist

torch.set_num_threads(1)

TOL = 1e-5
WORLD = 4
HANG_S = 150          # a rank that waits this long on a collective fails
S = 32
EP = {"moe_expert_parallel": True}
QWEN, MOE, SCOUT = "qwen3-0.6b", "qwen2-moe-a2.7b", "llama4-scout-17b-a16e"
CASES = {
    "qwen3-train": (QWEN, "train", 4, {}),
    "qwen3-prefill": (QWEN, "prefill", 4, {}),
    "qwen3-decode": (QWEN, "decode", 4, {}),
    "qwen3-decode-seq-sharded": (QWEN, "decode", 1, {}),
    "moe-train-ep": (MOE, "train", 4, EP),
    "moe-train-by-width": (MOE, "train", 4, {}),
    "moe-train-ep-odd-width": (MOE, "train", 4, {**EP, "d_ff": 510}),
    "moe-train-replicated": (MOE, "train", 4, {"d_ff": 510}),
    "moe-train-ep-unsplit-batch": (MOE, "train", 1, EP),
    "scout-train-ep": (SCOUT, "train", 4, EP),
    "moe-prefill-ep": (MOE, "prefill", 4, EP),
}
SHAPE_IDS = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(b.abs().max().item(), 1e-30))


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _errors(mesh, arch, kind, B, over) -> dict:
    """The case's largest relative errors against the unsharded port."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.models.config import ShapeConfig
    from repro_torch.nn.module import tree_leaves, tree_paths, tree_unflatten
    from repro_torch.train.optimizer import sgd

    cfg = get_config(arch)
    red = dataclasses.replace(cfg.reduced(), **over)
    overrides = {f.name: getattr(red, f.name)
                 for f in dataclasses.fields(red)
                 if getattr(red, f.name) != getattr(cfg, f.name)}
    model = registry.build_model(red)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, red.vocab, (B, S)).astype(np.int32))
    sid = SHAPE_IDS[kind]
    shape = ShapeConfig(sid, S, B, kind)
    if kind == "train":
        opt = sgd(1.0)
        bundle = steps.make_step(arch, sid, mesh, overrides=overrides,
                                 shape=shape, optimizer=opt)
        _, state, met = bundle.run(mesh, params, opt.init(params),
                                   {"tokens": toks})
        leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
        loss, _ = model.loss(tree_unflatten(params, leaves),
                             {"tokens": toks})
        grads = torch.autograd.grad(loss, leaves)
        errs = {"loss": _rel(_full(met["loss"]), loss.detach())}
        for (path, _), got, want in zip(tree_paths(params),
                                        tree_leaves(state.mu), grads):
            errs[f"grad {path}"] = _rel(_full(got), want)
        return errs
    bundle = steps.make_step(arch, sid, mesh, overrides=overrides,
                             shape=shape)
    if kind == "prefill":
        got = bundle.run(mesh, params, {"tokens": toks})
        with torch.no_grad():
            want = model.forward(params, toks, last_only=True)[0][:, -1]
        return {"logits": _rel(_full(got), want)}
    token, idx = toks[:, :1], torch.tensor(5, dtype=torch.int32)
    caches = model.init_cache(B, S, torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for c in tree_leaves(caches):
        c.normal_(generator=gen)
    plain = tree_unflatten(caches, [c.clone() for c in tree_leaves(caches)])
    logits, new = bundle.run(mesh, params, token, caches, idx)
    want, _ = model.decode_step(params, token, plain, idx)
    errs = {"logits": _rel(_full(logits), want)}
    for (path, _), got, ref in zip(tree_paths(new), tree_leaves(new),
                                   tree_leaves(plain)):
        errs[f"cache {path}"] = _rel(_full(got), ref)
    return errs


def _worker(rank, port, out):
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    results = {}
    for name, (arch, kind, B, over) in CASES.items():
        try:
            results[name] = _errors(mesh, arch, kind, B, over)
        except Exception as e:     # the case fails, the others still run
            results[name] = {"error": repr(e)}
            break                  # the ranks may disagree from here on
    if rank == 0:
        with open(out, "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path_factory.mktemp("ranks") / "errors.json"
    torch.multiprocessing.start_processes(
        _worker, args=(port, str(out)), nprocs=WORLD, start_method="spawn")
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_on_four_ranks_matches_the_unsharded_port(results,
                                                                case):
    errs = results.get(case)
    assert errs is not None, "an earlier case failed first"
    assert "error" not in errs, errs["error"]
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])
