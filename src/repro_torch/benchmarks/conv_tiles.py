"""Every tile plan of the layer kernels (K2, K3) timed on the card, against
the plan ``core.passplan.plan_conv_tiles`` picks; and the host time of
their wrappers' launch path.

For each layer of the standard encoder at the served 84x84x12 frame, at a
batch of 8, and at two 400x400x4 frames, it launches K3 (and K2 on the
layer's first 4-channel group view) with each plan of
``conv_candidates``, captured 10 launches to a CUDA graph and replayed, so
that the time is the device's and not the host's launch path.  It prints,
per layer and kernel, the planner's plan and its time, the fastest plan
and its time, and the rank of the planner's plan, and writes every
(plan, modelled cost, time) to ``--out`` (``build/conv_tiles.json`` by
default).  Then it searches a grid of the planner's cost-model constants
(``core.passplan.ConvCost``) for those whose picks come closest to the
fastest plans, and prints the best and the shipped ``CONV_COST``; with
``--fit PATH`` it runs that search alone, on the CPU, over a sweep that
an earlier run wrote.  First it
prints the host time of one call (many calls without a synchronize, so
the thread's own time) of K2's and K3's wrappers, of ``F.conv2d`` on the
same layer, and of the pieces of the wrappers' launch path; then the
device time of a one-block launch, the floor under every layer's.

    python -m repro_torch.benchmarks.conv_tiles [--out PATH]
    python -m repro_torch.benchmarks.conv_tiles --fit PATH
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.core.miniconv import standard_spec
from repro_torch.core.passplan import (CONV_COST, ConvCost, conv_candidates,
                                      conv_tile_layout, pick_conv_plan,
                                      plan_conv_tiles)
from repro_torch.kernels._build import BUILD_DIR
from repro_torch.kernels.miniconv_pass import launch_layer
from repro_torch.kernels.ops import same_pad

LAUNCHES = 10   # launches a captured graph holds
REPLAYS = 5     # replays of the graph between two events
# The cost-model constants the fit tries: each on a ladder around the
# shipped value.
FIT_GRID = dict(warp_alone_cpi=(1, 2, 4), load_cost=(1, 2, 4, 8),
                block_cycles=(0, 125, 250, 500, 1000, 2000),
                sm_bytes_per_cycle=(32, 64, 128, 256),
                l2_bytes_per_cycle=(750, 1500, 3000, 6000))


def graph_us(fn, replays: int = REPLAYS) -> float:
    """Device time of one call of ``fn`` in microseconds: ``LAUNCHES``
    calls captured to a CUDA graph, the graph replayed ``replays`` times
    between two events."""
    fn()                                   # raises the smem limit, builds
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(LAUNCHES):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (replays * LAUNCHES)


def host_us(fn, calls: int = 3000) -> float:
    """Host time of one call of ``fn`` in microseconds."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return out


def host_pieces() -> dict:
    """Host time of a served layer-0 call through each wrapper, of
    ``F.conv2d`` on the same layer, and of the launch path's pieces."""
    import torch.nn.functional as F

    from repro_torch.kernels import miniconv_pass as k
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((1, 86, 86, 12), generator=gen).to(dev)
    w = torch.rand((4, 4, 12, 16), generator=gen).to(dev)
    b = torch.rand((16,), generator=gen).to(dev)
    wg, bg = w[..., :4], b[:4]       # a group view, as ops passes it
    xn = x.permute(0, 3, 1, 2).contiguous()
    wn = wg.permute(3, 2, 0, 1).contiguous()
    out = {
        "K2 wrapper": host_us(lambda: k.miniconv_pass(x, wg, bg, stride=2)),
        "K3 wrapper": host_us(lambda: k.miniconv_layer_grouped(
            x, w, b, stride=2)),
        "F.conv2d": host_us(lambda: F.conv2d(xn, wn, bg, stride=2)),
        "torch.cuda.current_stream(dev).cuda_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "torch._C._cuda_getCurrentRawStream": host_us(
            lambda: torch._C._cuda_getCurrentRawStream(0)),
        "torch.empty (1,42,42,4)": host_us(lambda: torch.empty(
            (1, 42, 42, 4), dtype=torch.float32, device=dev)),
    }
    for name, us in out.items():
        print(f"host {name}: {us:.2f} us a call", flush=True)
    return out


def floor_us() -> dict:
    """Device time of the smallest launches: one block of one output
    whose sum has one tap (the launch itself, one staging round trip, a
    store), and one block whose sum has layer 0's 192 (48 steps of 4
    input channels): what a lone thread's tap loop adds."""
    dev = torch.device("cuda")
    out = {}
    for label, k, s, c_in in (("1 tap", 1, 1, 4), ("192 taps", 4, 2, 12)):
        x = torch.rand((1, k, k, c_in), device=dev)
        w = torch.rand((k, k, c_in, 4), device=dev)
        b = torch.rand((4,), device=dev)
        tp = conv_tile_layout(1, 1, 1, k, k, s, c_in, 4, 1, 1, 4, (1, 4))
        out[label] = graph_us(lambda: launch_layer(
            x, w, b, stride=s, tp=tp, grouped=True))
        print(f"floor: one block, one output of {label}: {out[label]:.2f} "
              f"us a launch", flush=True)
    return out


def layer_cases(dev):
    """(label, x pre-padded, w, b, stride) for each standard layer at each
    shape, inputs random from a seed."""
    gen = torch.Generator().manual_seed(0)
    for label, B, H, c_in in (("served", 1, 84, 12), ("batch 8", 8, 84, 12),
                              ("400x400", 2, 400, 4)):
        plan = standard_spec(c_in=c_in, k=4).plan(H)
        y = torch.rand((B, H, H, c_in), generator=gen)
        for l in plan.layers:
            xp = same_pad(y, l.kernel, l.stride)
            w = torch.randn((l.kernel, l.kernel, l.c_in, l.c_out),
                            generator=gen) * 0.2
            b = torch.randn((l.c_out,), generator=gen) * 0.1
            yield (f"{label} layer {l.index}", xp.to(dev), w.to(dev),
                   b.to(dev), l.stride)
            y = torch.relu(torch.randn((B, l.out_h, l.out_w, l.c_out),
                                       generator=gen))


def sweep() -> list[dict]:
    dev = torch.device("cuda")
    rows = []
    for label, x, w, b, s in layer_cases(dev):
        B, h_in, w_in, c_in = x.shape
        kh, kw, _, c_out = w.shape
        ho, wo = (h_in - kh) // s + 1, (w_in - kw) // s + 1
        for grouped in (True, False):
            wt, bt = (w, b) if grouped else (w[..., :4], b[:4])
            co = c_out if grouped else 4
            pick = plan_conv_tiles(B, ho, wo, kh, kw, s, c_in, co, grouped)
            timed = []
            for tp in conv_candidates(B, ho, wo, kh, kw, s, c_in, co,
                                      grouped):
                us = graph_us(lambda: launch_layer(
                    x, wt, bt, stride=s, tp=tp, grouped=grouped))
                timed.append((us, tp))
            timed.sort(key=lambda t: t[0])
            pick_us = next(us for us, tp in timed if tp == pick)
            rank = [tp for _, tp in timed].index(pick)
            best_us, best = timed[0]
            kern = "K3" if grouped else "K2"
            print(f"{kern} {label} ({B},{ho},{wo},{co}) k{kh} s{s} c_in "
                  f"{c_in}: planner {_desc(pick)} {pick_us:.2f} us (rank "
                  f"{rank + 1} of {len(timed)}); fastest {_desc(best)} "
                  f"{best_us:.2f} us", flush=True)
            rows.append(dict(kernel=kern, layer=label, shape=[B, ho, wo, co],
                             kernel_size=kh, stride=s, c_in=c_in,
                             pick=dataclasses.asdict(pick), pick_us=pick_us,
                             rank=rank + 1,
                             plans=[dict(dataclasses.asdict(tp),
                                         cost=tp.cost, us=us)
                                    for us, tp in timed]))
    return rows


def _key(tp) -> tuple[int, ...]:
    """What tells two plans of one launch apart (a plan or its JSON)."""
    names = ("tile_h", "tile_w", "co_block", "pix", "cb")
    if isinstance(tp, dict):
        return tuple(tp[n] for n in names)
    return tuple(getattr(tp, n) for n in names)


def fit(rows: list[dict]) -> list[tuple[float, float, ConvCost]]:
    """For every model of ``FIT_GRID``: the mean and the largest, over the
    sweep's launches, of its pick's time over the fastest plan's, best
    mean first (among equals the shipped ``CONV_COST``, then grid
    order)."""
    cases = []
    for r in rows:
        B, ho, wo, co = r["shape"]
        k = r["kernel_size"]
        us = {_key(p): p["us"] for p in r["plans"]}
        cands = conv_candidates(B, ho, wo, k, k, r["stride"], r["c_in"], co,
                                r["kernel"] == "K3")
        cases.append((cands, us, min(us.values())))
    out = []
    for values in itertools.product(*FIT_GRID.values()):
        model = ConvCost(**dict(zip(FIT_GRID, values)))
        ratio = [us[_key(pick_conv_plan(cands, model))] / best
                 for cands, us, best in cases]
        out.append((sum(ratio) / len(ratio), max(ratio), model))
    return sorted(out, key=lambda t: (t[0], t[2] != CONV_COST))


def print_fit(rows: list[dict]) -> None:
    ranked = fit(rows)
    for i, (mean, worst, model) in enumerate(ranked):
        if i < 5 or model == CONV_COST:
            print(f"fit: rank {i + 1} of {len(ranked)}"
                  + (" (shipped CONV_COST)" if model == CONV_COST else "")
                  + f": pick over fastest mean {mean:.4f}x, at most "
                  f"{worst:.4f}x; {model}")


def _desc(tp) -> str:
    return (f"{tp.tile_h}x{tp.tile_w} tile, {tp.co_block} ch, "
            f"({tp.pix},{tp.cb}), {tp.threads} thr, {tp.blocks} blocks")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(BUILD_DIR.parent / "conv_tiles.json"))
    ap.add_argument("--fit", metavar="PATH",
                    help="only search the cost model over a sweep's JSON")
    args = ap.parse_args(argv)
    if args.fit:
        print_fit(json.loads(Path(args.fit).read_text())["rows"])
        return 0
    if not torch.cuda.is_available():
        print("conv_tiles: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    host = host_pieces()
    floor = floor_us()
    rows = sweep()
    ratio = [r["pick_us"] / r["plans"][0]["us"] for r in rows]
    print(f"planner's pick against the fastest plan: mean "
          f"{sum(ratio) / len(ratio):.4f}x, at most {max(ratio):.4f}x over "
          f"{len(rows)} launches")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "host_us": host,
                               "floor_us": floor, "rows": rows}))
    print(f"wrote {out}")
    print_fit(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
