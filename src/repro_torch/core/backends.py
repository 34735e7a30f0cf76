"""Execution-backend registry: HOW a compiled PassPlan is executed.

The port of ``repro.core.backends``, with the same names, aliases and
``False``/``None``/``True`` handling, so a manifest's ``backend`` field
names the same tier in both packages.

Registered backends
-------------------
``xla``
    Eager PyTorch SAME convs — the differentiable training path.  The name
    is the reference's and stays a backend name.
``reference`` (alias ``per_pass``)
    One per-pass CUDA kernel launch per
    :class:`~repro_torch.core.passplan.ShaderPass`; the shader oracle the
    fused tier is tested against.
``grouped``
    One CUDA kernel launch per layer, all output groups together.
``fused``
    The whole PassPlan as ONE CUDA kernel launch per batch.
``fused+head`` (alias ``fused_head``)
    ``fused`` with the server-side projection as the kernel's epilogue.
``fused+stream`` (alias ``fused_stream``)
    ``fused+head`` as a persistent kernel that streams the batch's halo
    tiles with ``chunk`` frames in flight (``max_safe_batch`` by
    default).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class ExecutionBackend:
    """One way of executing a compiled MiniConv pass plan.

    ``mode`` is the execution tier (``miniconv_apply``'s ``use_kernel``);
    ``fused_head`` marks backends whose head projection runs INSIDE the
    kernel epilogue rather than as a separate matmul.
    """

    name: str
    mode: str                    # miniconv_apply execution tier
    fused_head: bool = False
    streamed: bool = False       # batch-chunked streaming (fused only)
    description: str = ""


_REGISTRY: dict[str, ExecutionBackend] = {}
_ALIASES: dict[str, str] = {}


def register_backend(backend: ExecutionBackend, *,
                     aliases: Iterable[str] = ()) -> ExecutionBackend:
    """Register an execution backend (idempotent for identical entries)."""
    existing = _REGISTRY.get(backend.name)
    if existing is not None and existing != backend:
        raise ValueError(f"backend {backend.name!r} already registered "
                         f"as {existing}")
    _REGISTRY[backend.name] = backend
    for a in aliases:
        if _ALIASES.get(a, backend.name) != backend.name:
            raise ValueError(f"alias {a!r} already points at "
                             f"{_ALIASES[a]!r}")
        _ALIASES[a] = backend.name
    return backend


def backend_names(*, include_aliases: bool = False) -> tuple[str, ...]:
    names = list(_REGISTRY)
    if include_aliases:
        names += sorted(_ALIASES)
    return tuple(names)


def get_backend(name) -> ExecutionBackend:
    """Resolve a backend by name or alias.

    Also accepts the historical ``use_kernel`` values ``False``/``None``
    (-> ``xla``) and ``True`` (-> ``reference``).  Unknown names raise with
    the full registered list so a typo'd manifest fails loudly.
    """
    if name is False or name is None:
        name = "xla"
    elif name is True:           # backwards compat: old boolean flag
        name = "reference"
    if not isinstance(name, str):
        raise ValueError(f"backend must be a registered name, got {name!r}; "
                         f"registered: {', '.join(backend_names())}")
    resolved = _ALIASES.get(name, name)
    try:
        return _REGISTRY[resolved]
    except KeyError:
        raise ValueError(
            f"unknown execution backend {name!r}; registered backends: "
            f"{', '.join(backend_names(include_aliases=True))} "
            f"(False/None -> 'xla', True -> 'reference')") from None


register_backend(ExecutionBackend(
    "xla", "xla",
    description="eager PyTorch SAME convs — the differentiable training "
                "path"))
register_backend(ExecutionBackend(
    "reference", "per_pass",
    description="one CUDA kernel launch per ShaderPass (the shader oracle)"),
    aliases=("per_pass",))
register_backend(ExecutionBackend(
    "grouped", "grouped",
    description="one CUDA kernel launch per layer, all output groups"))
register_backend(ExecutionBackend(
    "fused", "fused",
    description="whole PassPlan as ONE CUDA kernel launch per batch"))
register_backend(ExecutionBackend(
    "fused+head", "fused", fused_head=True,
    description="fused kernel with the projection as an in-kernel epilogue"),
    aliases=("fused_head",))
register_backend(ExecutionBackend(
    "fused+stream", "fused", fused_head=True, streamed=True,
    description="fused+head streamed over batch chunks"),
    aliases=("fused_stream",))


__all__ = ["ExecutionBackend", "backend_names", "get_backend",
           "register_backend"]
