"""Determinism / RNG rules.

The scenario engine's replayability contract is that ``reset()``
restores a link/sim to a bitwise-identical trajectory.  That only holds
when ``reset()`` reconstructs the RNG (``np.random.default_rng(self.seed)``)
rather than reusing the advanced generator, and when nothing in the
serving/sim path draws from unseeded or global RNG state.

The port's simulators draw from numpy exactly as the reference's do, so
the numpy checks are the reference's.  The port's other randomness lives
in explicit ``torch.Generator`` objects, so a torch draw without
``generator=`` (torch's global generator) is the counterpart of a global
``np.random.<fn>`` draw.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.core import (
    Context,
    Finding,
    Rule,
    dotted_name,
    iter_functions,
    register_rule,
)

# unseeded-RNG scope: modules that feed seeded, replayable simulation
_RNG_SCOPES = ("src/repro_torch/serving/",)

# numpy global-state draw functions (np.random.<fn> without a Generator)
_GLOBAL_DRAWS = {
    "uniform",
    "normal",
    "random",
    "randint",
    "rand",
    "randn",
    "choice",
    "shuffle",
    "permutation",
    "exponential",
    "poisson",
}

# torch draws that read torch's global generator unless given generator=
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli"}


def _is_default_rng_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and dotted_name(node.func).endswith(
        "default_rng"
    )


def _rng_attrs_in(fn: ast.AST) -> List[str]:
    """self.X attributes assigned from default_rng(...) in this function."""
    out = []
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and any(
            _is_default_rng_call(v) for v in ast.walk(n.value)
        ):
            for t in n.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    out.append(t.attr)
    return out


def _check_rng_reset(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files:
        if f.tree is None:
            continue
        classes = {}
        for fn, cls in iter_functions(f.tree):
            if cls is None:
                continue
            classes.setdefault(cls, {})[fn.name] = fn
        for cls, methods in classes.items():
            rng_attrs: List[str] = []
            for ctor in ("__init__", "__post_init__"):
                if ctor in methods:
                    rng_attrs.extend(_rng_attrs_in(methods[ctor]))
            reset = methods.get("reset")
            if not rng_attrs or reset is None:
                continue
            reconstructs = any(
                _is_default_rng_call(n) for n in ast.walk(reset)
            )
            restores = any(
                isinstance(n, ast.Assign)
                and any(
                    attr in ast.unparse(t)
                    for t in n.targets
                    for attr in rng_attrs
                )
                for n in ast.walk(reset)
            )
            if not (reconstructs or restores):
                findings.append(
                    Finding(
                        "rng-reset",
                        f.path,
                        reset.lineno,
                        f"{cls.name}.reset() does not reconstruct or restore "
                        f"the RNG state it seeds in __init__/__post_init__ "
                        f"(self.{', self.'.join(sorted(set(rng_attrs)))}); "
                        "reset must re-run np.random.default_rng(self.seed) "
                        "or the replayed trajectory diverges",
                    )
                )
    return findings


def _in_rng_scope(path: str) -> bool:
    return any(scope in path for scope in _RNG_SCOPES)


def _check_rng_unseeded(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files:
        if f.tree is None or not _in_rng_scope(f.path):
            continue
        for n in ast.walk(f.tree):
            if not isinstance(n, ast.Call):
                continue
            name = dotted_name(n.func)
            parts = name.split(".")
            if name.endswith("default_rng"):
                seeded = bool(n.args and not (
                    isinstance(n.args[0], ast.Constant)
                    and n.args[0].value is None
                )) or any(k.arg == "seed" for k in n.keywords)
                if not seeded:
                    findings.append(
                        Finding(
                            "rng-unseeded",
                            f.path,
                            n.lineno,
                            "np.random.default_rng() constructed without a "
                            "seed in a sim/link/scenario module; pass the "
                            "owning object's seed so runs replay",
                        )
                    )
            elif (
                parts[-1] in _TORCH_DRAWS
                and parts[:-1] == ["torch"]
                and not any(
                    k.arg == "generator"
                    and not (
                        isinstance(k.value, ast.Constant) and k.value.value is None
                    )
                    for k in n.keywords
                )
            ):
                findings.append(
                    Finding(
                        "rng-unseeded",
                        f.path,
                        n.lineno,
                        f"torch global-generator draw {name}(...) in a "
                        "sim/link/scenario module; pass generator= a "
                        "seeded torch.Generator instead",
                    )
                )
            elif (
                parts[-1] in _GLOBAL_DRAWS
                and len(parts) >= 2
                and parts[-2] == "random"
            ):
                findings.append(
                    Finding(
                        "rng-unseeded",
                        f.path,
                        n.lineno,
                        f"global-state RNG draw {name}(...) in a "
                        "sim/link/scenario module; draw from a seeded "
                        "np.random.Generator instead",
                    )
                )
    return findings


register_rule(
    Rule(
        name="rng-reset",
        family="rng",
        description=(
            "classes that seed np.random.default_rng in __init__/"
            "__post_init__ must reconstruct or restore it in reset()"
        ),
        check=_check_rng_reset,
    )
)

register_rule(
    Rule(
        name="rng-unseeded",
        family="rng",
        description=(
            "no unseeded default_rng(), global np.random/random draws or "
            "torch draws without generator= inside sim/link/scenario "
            "modules (src/repro_torch/serving/)"
        ),
        check=_check_rng_unseeded,
    )
)
