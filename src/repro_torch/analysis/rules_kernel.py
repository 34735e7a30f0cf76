"""Kernel launch / shared-memory budget rules, plus the broad-except sweep.

The port's counterparts of the reference's two Pallas rules, pointed at
the CUDA kernels that ``kernels/_build.py`` builds and binds with ctypes:

``kernel-launch`` (AST; replaces ``kernel-interpret``): a launch site must
make explicitly the choices the run depends on.  Every function that calls
a launch function obtained from ``_build.launcher(...)`` (directly, or
through a helper that returns one; ``_build.launch`` is the port's one
such function) must pass the launch's returned ``cudaError_t`` to
``check_rc(...)`` — a dropped code is a launch that fails silently, a
hidden fallback — and must read the current stream explicitly (``torch._C.
_cuda_getCurrentRawStream`` or ``.cuda_stream``), or the kernel is queued
on a stream other than the one torch queued its inputs on.

``kernel-smem`` (runtime, arithmetic only — nothing is launched; replaces
``kernel-vmem``): for the paper's standard encoder configs, every fused
backend must admit at least a batch-1 launch under one block's shared
memory (``passplan.SMEM_LIMIT``), and the grouped kernel must fit each
layer's staged weights there.  K1 and K4 tile the frame, so their
batch-independent residency is the smallest tile with its weights read
from device memory; where even that does not fit, no tile plan exists.

``broad-except`` (AST): ``except Exception`` / bare ``except`` hides the
exact bug classes the rest of this engine looks for; outside allow-listed
compat probes each site needs a narrow type or a justified suppression.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from repro_torch.analysis.core import (
    Context,
    Finding,
    Rule,
    SourceFile,
    dotted_name,
    function_body,
    iter_functions,
    register_rule,
)


# --------------------------------------------------------------------------
# kernel-launch

_LAUNCHER = "launcher"
_CHECK_RC = "check_rc"
_STREAM_ATTR = "cuda_stream"
_RAW_STREAM = "_cuda_getCurrentRawStream"


def _last_name(node: ast.AST) -> str:
    return dotted_name(node).rsplit(".", 1)[-1]


def _gets_launch_fn(node: ast.AST, helpers: Set[str]) -> bool:
    """``launcher(...)`` or ``helper(...)``: a call that returns a launch
    function (not the launch itself)."""
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, (ast.Name, ast.Attribute))
        and _last_name(node.func) in ({_LAUNCHER} | helpers)
    )


def _launch_fn_names(body: List[ast.AST], helpers: Set[str]) -> Set[str]:
    """Names a function binds to a launch function."""
    out: Set[str] = set()
    for n in body:
        if isinstance(n, ast.Assign) and _gets_launch_fn(n.value, helpers):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
    return out


def _launch_helpers(
    fns: List[Tuple[SourceFile, ast.AST, List[ast.AST]]]
) -> Set[str]:
    """Functions that return a launch function, found to a
    fixed point so a helper of a helper counts too."""
    helpers: Set[str] = set()
    while True:
        found = set(helpers)
        for _f, fn, body in fns:
            bound = _launch_fn_names(body, helpers)
            for n in body:
                if isinstance(n, ast.Return) and n.value is not None and (
                    _gets_launch_fn(n.value, helpers)
                    or (isinstance(n.value, ast.Name) and n.value.id in bound)
                ):
                    found.add(fn.name)
        if found == helpers:
            return helpers
        helpers = found


def _check_kernel_launch(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    fns = [
        (f, fn, function_body(fn))
        for f in ctx.files
        if f.tree is not None
        for fn, _cls in iter_functions(f.tree)
    ]
    helpers = _launch_helpers(fns)
    for f, fn, body in fns:
        bound = _launch_fn_names(body, helpers)
        launches = [
            n
            for n in body
            if isinstance(n, ast.Call)
            and (
                _gets_launch_fn(n.func, helpers)
                or (isinstance(n.func, ast.Name) and n.func.id in bound)
            )
        ]
        if not launches:
            continue
        fname = getattr(fn, "name", "?")
        # everything inside check_rc(...)'s arguments: the launch call
        # itself, or the name its code was assigned to
        in_check = [
            x
            for n in body
            if isinstance(n, ast.Call) and _last_name(n.func) == _CHECK_RC
            for a in n.args
            for x in ast.walk(a)
        ]
        checked = {id(x) for x in in_check}
        checked_names = {x.id for x in in_check if isinstance(x, ast.Name)}
        rc_names = {
            id(n.value): [t.id for t in n.targets if isinstance(t, ast.Name)]
            for n in body
            if isinstance(n, ast.Assign)
        }
        for call in launches:
            if id(call) in checked or any(
                name in checked_names for name in rc_names.get(id(call), ())
            ):
                continue
            findings.append(
                Finding(
                    "kernel-launch",
                    f.path,
                    call.lineno,
                    f"kernel launch in {fname}() drops its cudaError_t: "
                    "pass the launch function's return code to "
                    "check_rc(...), or a failed launch goes unnoticed "
                    "and the caller reads an unwritten output",
                )
            )
        reads_stream = any(
            (isinstance(n, ast.Attribute) and n.attr == _STREAM_ATTR)
            or (isinstance(n, ast.Call) and _last_name(n.func) == _RAW_STREAM)
            for n in body
        )
        if not reads_stream:
            findings.append(
                Finding(
                    "kernel-launch",
                    f.path,
                    launches[0].lineno,
                    f"kernel launch in {fname}() reads no stream "
                    "explicitly: pass torch._C._cuda_getCurrentRawStream"
                    "(index) (or torch.cuda.current_stream(dev)"
                    ".cuda_stream), or the kernel is queued on a stream "
                    "other than the one torch queued its inputs on",
                )
            )
    return findings


# --------------------------------------------------------------------------
# kernel-smem

# (c_in, input size) pairs covering the paper's standard encoder configs
_AUDIT_CONFIGS = ((12, 84), (4, 64), (4, 128), (4, 256), (4, 400))


def audit_smem_budgets(smem_limit: int = 0) -> List[Finding]:
    """Static shared-memory audit: tile-plan arithmetic only, no kernel
    launches.

    A ``fused`` backend is unlaunchable at batch 1 when even its
    batch-independent residency, the smallest (1x1) tile with weights
    read from device memory plus the kernel's static shared memory,
    exceeds the limit: that is when ``passplan.plan_tiles`` refuses.  It
    is taken for K1 and, where the backend streams, for K4 (two input
    buffers).  The head's epilogue, at any width (the reference audits
    512), sums into device memory and ``SMEM_STATIC``, so the audit needs
    no head.  The
    ``grouped`` kernel stages each layer's weights whole, as
    ``tuning.launch_feasible`` counts them.
    """
    findings: List[Finding] = []
    try:
        from repro_torch.core.backends import backend_names, get_backend
        from repro_torch.core.miniconv import standard_spec
        from repro_torch.core.passplan import (
            SMEM_LIMIT,
            SMEM_STATIC,
            build_pass_plan,
            tile_layout,
        )
    except Exception as e:  # repro: allow(broad-except) -- audit must report, not crash on, an import failure
        return [
            Finding(
                "kernel-smem",
                "src/repro_torch/analysis/rules_kernel.py",
                1,
                f"cannot import the tile-plan machinery for the shared-"
                f"memory audit: {e!r}",
            )
        ]
    limit = smem_limit or SMEM_LIMIT
    for c_in, size in _AUDIT_CONFIGS:
        spec = standard_spec(c_in=c_in)
        plan = build_pass_plan(spec, size, size)
        for name in backend_names():
            b = get_backend(name)
            where = f"for c_in={c_in} {size}x{size}"
            if b.mode == "fused":
                kernels = [("K1", False)] + ([("K4", True)] if b.streamed else [])
                for kernel, streamed in kernels:
                    need = (
                        tile_layout(plan, 1, 1, streamed, False).smem_bytes
                        + SMEM_STATIC
                    )
                    if need > limit:
                        findings.append(
                            Finding(
                                "kernel-smem",
                                "src/repro_torch/core/backends.py",
                                1,
                                f"backend {name!r} cannot launch even "
                                f"batch=1 {where}: {kernel}'s smallest tile "
                                f"needs {need} B of shared memory, over the "
                                f"{limit} B a block may use (no tile plan "
                                "exists; streaming cannot help)",
                            )
                        )
            elif b.mode == "grouped":
                for i, layer in enumerate(plan.layers):
                    need = (
                        4 * layer.kernel * layer.kernel * layer.c_in
                        * layer.c_out_pad
                    )
                    if need > limit:
                        findings.append(
                            Finding(
                                "kernel-smem",
                                "src/repro_torch/core/backends.py",
                                1,
                                f"backend {name!r} cannot launch layer {i} "
                                f"{where}: its staged weights need {need} B "
                                f"of shared memory, over the {limit} B a "
                                "block may use",
                            )
                        )
    return findings


def _check_kernel_smem(ctx: Context) -> List[Finding]:
    if not ctx.runtime:
        return []
    return audit_smem_budgets()


# --------------------------------------------------------------------------
# broad-except

def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Tuple):
        names = [dotted_name(e) for e in t.elts]
    else:
        names = [dotted_name(t)]
    return any(n in ("Exception", "BaseException") for n in names)


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(
        isinstance(n, ast.Raise) and n.exc is None for n in ast.walk(handler)
    )


def _check_broad_except(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files:
        if f.tree is None:
            continue
        for n in ast.walk(f.tree):
            if not isinstance(n, ast.ExceptHandler) or not _is_broad(n):
                continue
            if _reraises(n):
                continue  # catch-to-cleanup-and-reraise is fine
            findings.append(
                Finding(
                    "broad-except",
                    f.path,
                    n.lineno,
                    "broad except handler swallows every bug class this "
                    "engine checks for; catch the specific exceptions or "
                    "add '# repro: allow(broad-except) -- <why>'",
                )
            )
    return findings


register_rule(
    Rule(
        name="kernel-launch",
        family="kernel",
        description=(
            "every CUDA launch from _build.launcher(...) passes its "
            "cudaError_t to check_rc and reads the current stream explicitly"
        ),
        check=_check_kernel_launch,
    )
)

register_rule(
    Rule(
        name="kernel-smem",
        family="kernel",
        description=(
            "fused backends must admit batch>=1 and grouped each layer's "
            "staged weights for the standard encoder configs under one "
            "block's shared memory (arithmetic only, nothing launched)"
        ),
        check=_check_kernel_smem,
    )
)

register_rule(
    Rule(
        name="broad-except",
        family="kernel",
        description=(
            "no bare/Exception-wide handlers without a justified "
            "suppression (re-raising handlers exempt)"
        ),
        check=_check_broad_except,
    )
)
