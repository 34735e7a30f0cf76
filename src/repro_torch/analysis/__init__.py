"""repro_torch.analysis — the repo's bug taxonomy, machine-checked on the port.

The port of ``repro.analysis``: the same AST-based engine, data types,
waiver syntax and CLI, with the rules that are bound to a runtime or a
framework pointed at the port: blocked warmups are torch's
synchronizations, unseeded draws include torch's global generator, the
registries are ``repro_torch``'s, and the two kernel rules audit the CUDA
launch sites (``kernel-launch``) and the shared-memory budget of the
fused and grouped kernels (``kernel-smem``).  The other rules are the
reference's: offsets-from-t_start scheduling, RNG reconstruction in
reset(), shutdown-before-close sockets, reaped workers, versioned
schemas, and justified broad excepts.

Run ``python -m repro_torch.analysis`` from the repo root; ``--strict``
gates new findings against ``src/repro_torch/analysis/baseline.json``.
Rules live in a registry (``RULES`` / ``register_rule``) exactly like the
execution backends, routers and link kinds they audit.  Nothing here
imports the reference package.
"""

from repro_torch.analysis.core import (
    Context,
    Finding,
    RULES,
    Rule,
    SourceFile,
    Suppression,
    analyze_source,
    get_rule,
    load_context,
    register_rule,
    rule_names,
    run_rules,
    _register_builtin_rules,
)
from repro_torch.analysis.baseline import (
    BASELINE_VERSION,
    baseline_problems,
    diff_against_baseline,
    load_baseline,
    save_baseline,
)

_register_builtin_rules()

__all__ = [
    "Context",
    "Finding",
    "RULES",
    "Rule",
    "SourceFile",
    "Suppression",
    "analyze_source",
    "get_rule",
    "load_context",
    "register_rule",
    "rule_names",
    "run_rules",
    "BASELINE_VERSION",
    "baseline_problems",
    "diff_against_baseline",
    "load_baseline",
    "save_baseline",
]
