"""Every K4 layout of the fused encoder's tile model timed on the card,
against the layout ``core.passplan.plan_tiles`` picks; K1 at the served
shapes; and a fit of the model's constants.

At the benchmark's two shapes (256 frames of 84x84x12 and 64 frames of
400x400x4, no head) it launches K4 with each layout of
``passplan.tile_candidates`` (tile size, frames a layer pass) on as many
persistent blocks as the card keeps resident, checks that its features
equal K1's bit for bit, and times it by CUDA events over ``ITERS``
launches.  It does the same, timing each launch's device time from a
profiler trace, at shapes the fit never sees (``HELD_OUT``: other frame
sizes past one wave, and batches streamed in small chunks, where the
planner passes several frames at once).  It prints, per shape, the
layouts from the fastest, each with its modelled cost and rank, and
marks the planner's pick.  Then K1 at (1,84,84,12) and (8,84,84,12) with
the 512-wide head, at each tile size (device time of one launch, from a
profiler trace), and K4 at config B (64 frames of 400x400x4 with the
head) with the planner's layout.  It writes every row to ``--out``
(``build/encoder_tiles.json`` by default), then searches a grid of the
model's constants (``passplan.EncoderCost``) for those whose picks come
closest to the fastest layouts at the benchmark's shapes, and prints the
shipped constants' rank correlation at the held-out ones; ``--fit PATH``
runs that search alone, on the CPU, over a sweep an earlier run wrote.

    python -m repro_torch.benchmarks.encoder_tiles [--out PATH]
    python -m repro_torch.benchmarks.encoder_tiles --fit PATH
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.core.miniconv import miniconv_init, standard_spec
from repro_torch.core.passplan import (ENCODER_COST, EncoderCost,
                                      pass_cycles, tile_candidates,
                                      tile_cost, tile_layout)
from repro_torch.kernels import _build
from repro_torch.kernels.miniconv_pass import launch_encoder

ITERS = 20      # launches between two events
# (label, c_in, side, frames, chunk) of the K4 sweep, chunk None for the
# plan's max_safe_batch: the benchmark's cells, which the fit reads
CASES = (("84x84x12 B=256", 12, 84, 256, None),
         ("400x400x4 B=64", 4, 400, 64, None))
# Shapes the fit does not read: other frame sizes past one wave, and
# batches a ``fused+stream`` deployment streams in small chunks (chip_smoke
# streams 8 frames of 84x84 in chunks of 3), where the planner passes two
# or four frames at once
HELD_OUT = (("84x84x9 B=256", 9, 84, 256, None),
            ("128x128x4 B=256", 4, 128, 256, None),
            ("84x84x12 B=8 chunk 3", 12, 84, 8, 3),
            ("84x84x12 B=32 chunk 8", 12, 84, 32, 8),
            ("84x84x12 B=69", 12, 84, 69, None),
            ("128x128x4 B=32 chunk 8", 4, 128, 32, 8),
            ("64x64x3 B=128 chunk 32", 3, 64, 128, 32),
            ("400x400x4 B=4 chunk 2", 4, 400, 4, 2))
# The model's constants the fit tries, each on a ladder around the shipped
# value.
FIT_GRID = dict(step_latency=(0, 5, 10, 15, 20, 25, 30, 40, 60, 80, 120),
                load_cost=(2, 4, 8, 16, 24, 32, 48, 64, 96))


def event_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` in ms: ``iters`` calls between
    two events after ``warmup``; a K4 launch outlasts its host path, so
    the device never waits for the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, calls: int = 50) -> float:
    """Device time in ms of one launch of ``kernel`` (a name in the
    trace), from a ``torch.profiler`` trace of ``calls`` calls of ``fn``:
    K1 at a few frames is shorter than its host path, so events between
    calls would time the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    n = sum(e.count for e in hits)
    if not n:
        raise RuntimeError(f"the profiler saw no {kernel} launch")
    return sum(e.self_device_time_total for e in hits) / n / 1e3


def _inputs(c_in: int, side: int, batch: int, head: int | None, dev,
            seed: int = 0):
    spec = standard_spec(c_in=c_in, k=4)
    plan = spec.plan(side)
    gen = torch.Generator().manual_seed(seed)
    params = miniconv_init(gen, spec, device=dev)
    ws = [params[f"layer{i}"]["kernel"] for i in range(len(spec.layers))]
    bs = [(torch.randn(l.c_out, generator=gen) * 0.1).to(dev)
          for l in spec.layers]
    x = torch.rand((batch, side, side, c_in), generator=gen).to(dev)
    hw = hb = None
    if head is not None:
        hw = (torch.randn(plan.flat_features, head, generator=gen)
              * 0.05).to(dev)
        hb = (torch.randn(head, generator=gen) * 0.1).to(dev)
    return plan, x, ws, bs, hw, hb


def _key(tp) -> tuple[int, ...]:
    return (tp.tile_h, tp.frames)


def _row(tp, **kw) -> dict:
    return dict(tile=tp.tile_h, frames=tp.frames,
                shapes=[[lt.pix, lt.co_block] for lt in tp.layers],
                smem=tp.smem_bytes, blocks_per_sm=tp.blocks_per_sm, **kw)


def sweep(dev, cases=CASES, events: bool = True) -> list[dict]:
    """Every K4 layout at each of ``cases``, bitwise against K1, timed by
    events (``events``) or from a profiler trace."""
    rows = []
    for label, c_in, side, batch, chunk in cases:
        plan, x, ws, bs, _, _ = _inputs(c_in, side, batch, None, dev)
        chunk = chunk or plan.max_safe_batch()
        k1 = plan.tile_plan(batch)
        want = launch_encoder(x, ws, bs, plan, k1)
        pick = plan.tile_plan(batch, streamed=True)
        for tp in tile_candidates(plan):
            def run(tp=tp):
                return launch_encoder(x, ws, bs, plan, tp, chunk_b=chunk)
            equal = torch.equal(run(), want)
            ms = (event_ms(run) if events
                  else device_ms(run, "encoder_stream_kernel"))
            rows.append(_row(tp, case=label, batch=batch, chunk=chunk,
                             ms=ms, cost=tile_cost(tp, batch), equal=equal,
                             picked=_key(tp) == _key(pick)))
        del x, want
    return rows


def k1_rows(dev) -> list[dict]:
    """K1 at the served shape and at a batch of 8 with the head, at each
    tile size that fits."""
    rows = []
    for label, batch, head in (("K1 (1,84,84,12)", 1, None),
                               ("K1 (8,84,84,12)+head", 8, 512)):
        plan, x, ws, bs, hw, hb = _inputs(12, 84, batch, head, dev, seed=1)
        pick = plan.tile_plan(batch)
        for t in range(1, 6):
            tp = tile_layout(plan, t, t)

            def run(tp=tp):
                return launch_encoder(x, ws, bs, plan, tp, head_w=hw,
                                      head_b=hb)
            rows.append(_row(tp, case=label, batch=batch,
                             ms=device_ms(run, "encoder_kernel"),
                             picked=tp.tile_h == pick.tile_h))
    return rows


def config_b_rows(dev) -> list[dict]:
    """K4 at config B (64 frames of 400x400x4, the 512-wide head, the
    plan's chunk) with the planner's layout, z bitwise against K1's."""
    plan, x, ws, bs, hw, hb = _inputs(4, 400, 64, 512, dev, seed=2)
    pick = plan.tile_plan(64, streamed=True)
    chunk = plan.max_safe_batch()
    fb, zb = launch_encoder(x, ws, bs, plan, plan.tile_plan(64), head_w=hw,
                            head_b=hb)

    def run():
        return launch_encoder(x, ws, bs, plan, pick, chunk_b=chunk,
                              head_w=hw, head_b=hb)
    f, z = run()
    return [_row(pick, case="config B (64,400,400,4)+head", batch=64,
                 ms=event_ms(run, iters=10),
                 equal=torch.equal(f, fb) and torch.equal(z, zb),
                 picked=True)]


def _measured(row: dict):
    """The layout a sweep row timed, rebuilt on the CPU with the
    register tiles it ran."""
    c_in, side = next((c[1], c[2]) for c in CASES + HELD_OUT
                      if c[0] == row["case"])
    plan = standard_spec(c_in=c_in, k=4).plan(side)
    tp = tile_layout(plan, row["tile"], row["tile"], True,
                     frames=row["frames"])
    layers = tuple(dataclasses.replace(lt, pix=p, co_block=cb)
                   for lt, (p, cb) in zip(tp.layers, row["shapes"]))
    return plan, dataclasses.replace(tp, layers=layers)


def _by_case(rows: list[dict], cases) -> dict:
    names = {c[0] for c in cases}
    out = {}
    for r in rows:
        if r["case"] in names:
            plan, tp = _measured(r)
            out.setdefault(r["case"], []).append((plan, tp, r))
    return out


def score(members, model: EncoderCost) -> tuple[float, float]:
    """(log of the time of the cheapest layout by ``model`` over the
    fastest, rank correlation of the modelled costs with the times) over
    one shape's timed layouts."""
    costs, times = [], []
    for plan, tp, r in members:
        work, chain = pass_cycles(plan, tp, model)
        costs.append(tile_cost(dataclasses.replace(tp, work=work,
                                                   chain=chain), r["batch"]))
        times.append(r["ms"])
    pick = min(range(len(costs)), key=costs.__getitem__)
    return math.log(times[pick] / min(times)), _spearman(costs, times)


def fit(rows: list[dict]) -> list[tuple[float, float, EncoderCost]]:
    """Every point of ``FIT_GRID``, scored over the K4 sweep's shapes of
    ``CASES``: (the summed log of the pick's time over the fastest, minus
    the mean rank correlation of the modelled costs with the times, the
    constants), best first."""
    cases = _by_case(rows, CASES)
    out = []
    for vals in itertools.product(*FIT_GRID.values()):
        model = EncoderCost(**dict(zip(FIT_GRID, vals)))
        scores = [score(m, model) for m in cases.values()]
        out.append((sum(r for r, _ in scores),
                    -sum(c for _, c in scores) / len(cases), model))
    out.sort(key=lambda o: (o[0], o[1]))
    return out


def _spearman(a: list[float], b: list[float]) -> float:
    def ranks(v):
        order = sorted(range(len(v)), key=v.__getitem__)
        r = [0.0] * len(v)
        for i, k in enumerate(order):
            r[k] = i
        return r
    ra, rb = ranks(a), ranks(b)
    n = len(a)
    return 1 - 6 * sum((x - y) ** 2 for x, y in zip(ra, rb)) / (
        n * (n * n - 1)) if n > 1 else 1.0


def print_fit(rows: list[dict]) -> None:
    ranked = fit(rows)
    shipped = next(o for o in ranked if o[2] == ENCODER_COST)
    for regret, corr, model in ranked[:5]:
        print(f"fit: {model}: log regret {regret:.4f}, rank correlation "
              f"{-corr:.3f}")
    print(f"fit: shipped {ENCODER_COST}: log regret {shipped[0]:.4f}, rank "
          f"correlation {-shipped[1]:.3f} (rank {ranked.index(shipped) + 1} "
          f"of {len(ranked)})")
    for case, members in _by_case(rows, HELD_OUT).items():
        regret, corr = score(members, ENCODER_COST)
        print(f"held out: {case}: shipped constants' pick "
              f"{math.exp(regret):.3f}x the fastest, rank correlation "
              f"{corr:.3f}")


def _desc(r: dict) -> str:
    shapes = " ".join(f"({p},{cb})" for p, cb in r["shapes"])
    return (f"T={r['tile']} F={r['frames']} {r['smem']} B "
            f"x{r['blocks_per_sm']} [{shapes}]")


def report(rows: list[dict]) -> None:
    for case in dict.fromkeys(r["case"] for r in rows):
        mine = sorted((r for r in rows if r["case"] == case),
                      key=lambda r: r["ms"])
        by_cost = sorted(mine, key=lambda r: r.get("cost", 0.0))
        print(f"== {case}")
        for r in mine:
            rank = (f" model rank {by_cost.index(r) + 1}, cost "
                    f"{r['cost']:.0f}" if "cost" in r else "")
            eq = "" if "equal" not in r else (
                " bitwise K1" if r["equal"] else " DIFFERS FROM K1")
            print(f"  {r['ms']:.4f} ms  {_desc(r)}{rank}{eq}"
                  + ("  <- planner" if r["picked"] else ""))
        pick = next((r for r in mine if r["picked"]), None)
        if pick is not None and pick["frames"] > 1:
            same = next(r for r in mine if r["tile"] == pick["tile"]
                        and r["frames"] == 1)
            one = next(r for r in mine if r["frames"] == 1)
            print(f"  frames: the pick T={pick['tile']} F={pick['frames']} "
                  f"{pick['ms']:.4f} ms; F=1 at its tile {same['ms']:.4f} "
                  f"ms; the fastest F=1 layout T={one['tile']} "
                  f"{one['ms']:.4f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(_build.BUILD_DIR.parent
                                         / "encoder_tiles.json"))
    ap.add_argument("--fit", metavar="PATH",
                    help="fit the model to an earlier sweep, on the CPU")
    args = ap.parse_args(argv)
    if args.fit:
        print_fit(json.loads(Path(args.fit).read_text())["rows"])
        return 0
    if not torch.cuda.is_available():
        print("encoder_tiles: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    built = _build.build(["miniconv_encoder"])
    for info in built.values():
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "spill")):
                print(f"ptxas: {line.strip()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; torch {torch.__version__}")
    rows = (sweep(dev) + sweep(dev, HELD_OUT, events=False) + k1_rows(dev)
            + config_b_rows(dev))
    report(rows)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card.strip(), "rows": rows},
                              indent=1))
    print(f"wrote {out}")
    print_fit(rows)
    bad = [r for r in rows if r.get("equal") is False]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
