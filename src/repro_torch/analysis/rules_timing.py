"""Timing-hygiene rules.

The port's latency claims come from ``time.perf_counter()`` windows
around torch calls that launch CUDA kernels.  Two bug classes:

* reading the clock while device work is still in flight — torch's
  kernel launches are asynchronous, so a window that isn't preceded by a
  warmup + synchronize measures the launch (microseconds) or a first
  call's build and autotuning (seconds), not the kernel;
* accumulating periods onto a raw monotonic clock value (``t += period``)
  instead of scheduling offsets from ``t_start`` — float error compounds
  and the schedule drifts (a ``run_load`` flake the fleet once had).
"""

from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.core import (
    Context,
    Finding,
    Rule,
    dotted_name,
    function_body,
    iter_functions,
    register_rule,
)

_CLOCKS = {"perf_counter", "monotonic", "time"}
# what waits for the device in the port: torch.cuda.synchronize(), a CUDA
# event's or stream's .synchronize(), and the port's helpers _block(...)
# (serving.server) and _sync() (train.trainer)
_SYNC_NAMES = ("synchronize", "_sync")
_BLOCK_SUFFIX = "_block"


def _is_perf_counter_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    return name == "perf_counter" or name.endswith(".perf_counter")


def _is_block_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    last = name.rsplit(".", 1)[-1]
    return last in _SYNC_NAMES or last.endswith(_BLOCK_SUFFIX)


def _check_warmup(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files:
        if f.tree is None:
            continue
        for fn, _cls in iter_functions(f.tree):
            body = function_body(fn)
            pc_lines = sorted(
                n.lineno for n in body if _is_perf_counter_call(n)
            )
            if len(pc_lines) < 2:
                continue  # a single read is not a timing window
            # the timed region must contain something to measure
            first = pc_lines[0]
            timed_calls = [
                n
                for n in body
                if isinstance(n, ast.Call)
                and n.lineno >= first
                and not _is_perf_counter_call(n)
            ]
            if not timed_calls:
                continue
            block_lines = [n.lineno for n in body if _is_block_call(n)]
            if not any(b < first for b in block_lines):
                findings.append(
                    Finding(
                        "timing-warmup",
                        f.path,
                        first,
                        f"perf_counter window in {getattr(fn, 'name', '?')}() "
                        "with no preceding synchronized warmup: run the "
                        "work once and call torch.cuda.synchronize() (or "
                        "<event>.synchronize(), _block(...), _sync()) "
                        "before the first clock read, or the window times "
                        "torch's asynchronous launches or a first call's "
                        "build instead of the work",
                    )
                )
    return findings


def _is_clock_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    parts = name.rsplit(".", 1)
    if len(parts) == 2:
        return parts[0].endswith("time") and parts[1] in _CLOCKS
    return False


def _contains_clock_call(node: ast.AST) -> bool:
    return any(_is_clock_call(n) for n in ast.walk(node))


def _target_text(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except (ValueError, RecursionError):  # unparse of odd targets
        return ""


def _check_monotonic_accum(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files:
        if f.tree is None:
            continue
        for fn, _cls in iter_functions(f.tree):
            body = function_body(fn)
            clock_vars = {}  # target text -> first assignment line
            for n in body:
                if isinstance(n, ast.Assign) and _contains_clock_call(n.value):
                    for t in n.targets:
                        text = _target_text(t)
                        if text:
                            clock_vars.setdefault(text, n.lineno)
            if not clock_vars:
                continue
            for n in body:
                if isinstance(n, ast.AugAssign) and isinstance(
                    n.op, (ast.Add, ast.Sub)
                ):
                    text = _target_text(n.target)
                elif (
                    isinstance(n, ast.Assign)
                    and len(n.targets) == 1
                    and isinstance(n.value, ast.BinOp)
                    and isinstance(n.value.op, (ast.Add, ast.Sub))
                    and _target_text(n.targets[0])
                    in (
                        _target_text(n.value.left),
                        _target_text(n.value.right),
                    )
                ):
                    text = _target_text(n.targets[0])
                else:
                    continue
                if text in clock_vars and n.lineno > clock_vars[text]:
                    findings.append(
                        Finding(
                            "timing-monotonic-accum",
                            f.path,
                            n.lineno,
                            f"{text!r} accumulates onto a raw monotonic "
                            "clock value; schedule as offsets from t_start "
                            "(t_start + i * period) so float error cannot "
                            "compound into schedule drift",
                        )
                    )
    return findings


register_rule(
    Rule(
        name="timing-warmup",
        family="timing",
        description=(
            "perf_counter timing windows must be preceded by a warmup that "
            "waits for the device (torch.cuda.synchronize / "
            "<event>.synchronize / _block / _sync)"
        ),
        check=_check_warmup,
    )
)

register_rule(
    Rule(
        name="timing-monotonic-accum",
        family="timing",
        description=(
            "never accumulate periods onto a raw monotonic clock value; "
            "derive deadlines as offsets from a fixed t_start"
        ),
        check=_check_monotonic_accum,
    )
)
