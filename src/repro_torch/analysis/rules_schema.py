"""Schema / registry consistency rules.

Every frozen config dataclass that serialises (``to_dict``/``from_dict``)
must carry a schema version and refuse unknown versions — the manifests
(`DeploymentConfig` v2, `Scenario`, `TunedPlan`, `ShapingConfig`) are
long-lived JSON artifacts and silent field drops are how stale benchmark
baselines sneak in.  Separately, every name registered in source must
actually exist in the imported registry (a registration inside a failed
conditional is invisible at runtime), and every registry entry must be
constructible and JSON-round-trippable.  The registries checked are the
port's (``repro_torch.serving`` and ``repro_torch.core``).
"""

from __future__ import annotations

import ast
import json
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.core import (
    Context,
    Finding,
    Rule,
    dotted_name,
    register_rule,
)


# --------------------------------------------------------------------------
# schema-version: versioned to_dict/from_dict on frozen config dataclasses

def _is_frozen_dataclass(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        try:
            text = ast.unparse(dec)
        except (ValueError, RecursionError):
            continue
        if "dataclass" in text and "frozen=True" in text:
            return True
    return False


def _mentions_version(fn: ast.AST) -> bool:
    for n in ast.walk(fn):
        if isinstance(n, ast.Constant) and n.value == "version":
            return True
        if isinstance(n, ast.Name) and "VERSION" in n.id:
            return True
    return False


def _rejects_unknown_version(fn: ast.AST) -> bool:
    """from_dict must be able to refuse: a raise, or a call into a
    version-checking helper (e.g. repro_torch.schema.check_version)."""
    for n in ast.walk(fn):
        if isinstance(n, ast.Raise):
            return True
        if isinstance(n, ast.Call) and "version" in dotted_name(n.func).lower():
            return True
    return False


def _check_schema_version(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files:
        if f.tree is None:
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.ClassDef) or not _is_frozen_dataclass(
                node
            ):
                continue
            methods = {
                n.name: n
                for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            to_dict, from_dict = methods.get("to_dict"), methods.get("from_dict")
            if to_dict is None or from_dict is None:
                continue  # not a serialised schema (or one-way export)
            # a `version` dataclass field serialises through asdict()
            has_version_field = any(
                isinstance(n, ast.AnnAssign)
                and isinstance(n.target, ast.Name)
                and n.target.id == "version"
                for n in node.body
            )
            problems = []
            if not (_mentions_version(to_dict) or has_version_field):
                problems.append("to_dict() does not write a 'version' field")
            if not (_mentions_version(from_dict) and _rejects_unknown_version(from_dict)):
                problems.append(
                    "from_dict() does not check the version and raise on "
                    "unknown ones"
                )
            if problems:
                findings.append(
                    Finding(
                        "schema-version",
                        f.path,
                        node.lineno,
                        f"frozen config dataclass {node.name} serialises "
                        f"without schema versioning: {'; '.join(problems)} "
                        "(see repro_torch.schema.check_version)",
                    )
                )
    return findings


# --------------------------------------------------------------------------
# registry-roundtrip: AST-registered names must exist in the imported
# registries, and registry entries must survive a JSON round-trip

# register function -> (module, registry accessor returning {name: entry})
_REGISTRIES: Dict[str, Tuple[str, Callable]] = {
    "register_router": ("repro_torch.serving.fleet", lambda m: m.ROUTERS),
    "register_link_kind": (
        "repro_torch.serving.netsim", lambda m: m.LINK_KINDS),
    "register_scenario": (
        "repro_torch.serving.scenario", lambda m: m.SCENARIOS),
    "register_adaptation": (
        "repro_torch.serving.scenario", lambda m: m.ADAPTATIONS),
    "register_profile": (
        "repro_torch.serving.profiles", lambda m: m.DEVICE_PROFILES),
    "register_backend": (
        "repro_torch.core.backends",
        lambda m: {n: m.get_backend(n) for n in m.backend_names()},
    ),
}


def _registered_name(call: ast.Call) -> Optional[str]:
    """Literal name a register_*() call registers, or None if dynamic."""
    if call.args and isinstance(call.args[0], ast.Constant):
        if isinstance(call.args[0].value, str):
            return call.args[0].value
    if call.args and isinstance(call.args[0], ast.Call):
        ctor = call.args[0]
        for k in ctor.keywords:
            if (
                k.arg == "name"
                and isinstance(k.value, ast.Constant)
                and isinstance(k.value.value, str)
            ):
                return k.value.value
        if ctor.args and isinstance(ctor.args[0], ast.Constant):
            if isinstance(ctor.args[0].value, str):
                return ctor.args[0].value
    return None


def _check_registry_roundtrip(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    import importlib

    # AST half: cross-reference literal register_*() names against the
    # live registries (runs for fixtures too — only the named registry's
    # module is imported)
    for f in ctx.files:
        if f.tree is None:
            continue
        for n in ast.walk(f.tree):
            if not isinstance(n, ast.Call):
                continue
            fn_name = dotted_name(n.func).rsplit(".", 1)[-1]
            if fn_name not in _REGISTRIES:
                continue
            name = _registered_name(n)
            if name is None:
                continue
            module_name, accessor = _REGISTRIES[fn_name]
            try:
                registry = accessor(importlib.import_module(module_name))
            except Exception as e:  # repro: allow(broad-except) -- audit must report, not crash on, a registry import failure
                findings.append(
                    Finding(
                        "registry-roundtrip",
                        f.path,
                        n.lineno,
                        f"cannot import {module_name} to verify "
                        f"{fn_name}({name!r}): {e!r}",
                    )
                )
                continue
            if name not in registry:
                findings.append(
                    Finding(
                        "registry-roundtrip",
                        f.path,
                        n.lineno,
                        f"{fn_name}({name!r}) appears in source but "
                        f"{name!r} is missing from the live "
                        f"{module_name} registry — registration is dead "
                        "code or conditional",
                    )
                )

    if ctx.runtime:
        findings.extend(check_registries())
    return findings


def check_registries() -> List[Finding]:
    """Runtime half: construct + JSON-round-trip every registry entry."""
    findings: List[Finding] = []

    def report(path: str, msg: str) -> None:
        findings.append(Finding("registry-roundtrip", path, 1, msg))

    try:
        from repro_torch.core.backends import backend_names, get_backend
        from repro_torch.serving.fleet import ROUTERS
        from repro_torch.serving.netsim import LINK_KINDS
        from repro_torch.serving.profiles import DEVICE_PROFILES
        from repro_torch.serving.scenario import (ADAPTATIONS, SCENARIOS,
                                                  Scenario)
        from repro_torch.core.wire import CODECS
    except Exception as e:  # repro: allow(broad-except) -- audit must report, not crash on, a registry import failure
        report("src/repro_torch/analysis/rules_schema.py", f"registry import failed: {e!r}")
        return findings

    for name in backend_names():
        b = get_backend(name)
        if b.name != name:
            report(
                "src/repro_torch/core/backends.py",
                f"backend registered as {name!r} reports name {b.name!r}",
            )

    for name, fn in ROUTERS.items():
        if not callable(fn):
            report("src/repro_torch/serving/fleet.py", f"router {name!r} is not callable")

    for name, builder in LINK_KINDS.items():
        if not callable(builder):
            report(
                "src/repro_torch/serving/netsim.py",
                f"link kind {name!r} builder is not callable",
            )

    for name, codec in CODECS.items():
        if getattr(codec, "name", name) != name:
            report(
                "src/repro_torch/core/wire.py",
                f"codec registered as {name!r} reports name "
                f"{getattr(codec, 'name', None)!r}",
            )

    for name, p in DEVICE_PROFILES.items():
        if p.name != name:
            report(
                "src/repro_torch/serving/profiles.py",
                f"profile registered as {name!r} reports name {p.name!r}",
            )

    for name, factory in ADAPTATIONS.items():
        if not callable(factory):
            report(
                "src/repro_torch/serving/scenario.py",
                f"adaptation {name!r} factory is not callable",
            )

    for name, sc in SCENARIOS.items():
        path = "src/repro_torch/serving/scenario.py"
        if sc.name != name:
            report(path, f"scenario registered as {name!r} reports {sc.name!r}")
            continue
        try:
            wire = json.loads(json.dumps(sc.to_dict()))
            back = Scenario.from_dict(wire)
        except Exception as e:  # repro: allow(broad-except) -- audit must report, not crash on, a schema round-trip failure
            report(path, f"scenario {name!r} JSON round-trip raised: {e!r}")
            continue
        if back != sc:
            report(
                path,
                f"scenario {name!r} does not survive to_dict->json->"
                "from_dict bitwise",
            )
        try:
            sc.validate()
        except Exception as e:  # repro: allow(broad-except) -- audit must report, not crash on, a scenario validation failure
            report(path, f"scenario {name!r} fails validate(): {e!r}")

    return findings


register_rule(
    Rule(
        name="schema-version",
        family="schema",
        description=(
            "frozen config dataclasses with to_dict/from_dict must write a "
            "version and refuse unknown versions on load"
        ),
        check=_check_schema_version,
    )
)

register_rule(
    Rule(
        name="registry-roundtrip",
        family="schema",
        description=(
            "register_*() names in source must exist in the live registry; "
            "every registry entry constructs and JSON-round-trips"
        ),
        check=_check_registry_roundtrip,
    )
)
