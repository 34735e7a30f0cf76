"""Concurrency / socket-lifecycle rules.

The real fleet (``serving/realfleet.py``) taught us two invariants the
hard way: a TCP socket closed without a prior ``shutdown(SHUT_RDWR)``
leaves the peer's reader thread blocked in ``recv`` until its timeout,
and a spawned worker process without a join/terminate on every exit path
is a leaked process the CI gate will catch minutes later.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.core import (
    Context,
    Finding,
    Rule,
    dotted_name,
    iter_functions,
    register_rule,
)

_SOCKET_CTORS = {"socket.socket", "socket.create_connection"}


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except (ValueError, RecursionError):
        return ""


def _is_socket_ctor(node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name in _SOCKET_CTORS:
            return True
        if name.endswith(".accept"):
            return True
    return False


def _socket_targets(assign: ast.Assign) -> List[str]:
    """Names bound to a socket by this assignment.

    ``conn, addr = listener.accept()`` binds the socket to the first
    element of the tuple target.
    """
    value = assign.value
    if not _is_socket_ctor(value):
        return []
    out = []
    for t in assign.targets:
        if isinstance(t, ast.Tuple) and t.elts:
            out.append(_unparse(t.elts[0]))
        else:
            out.append(_unparse(t))
    return [o for o in out if o]


def _check_socket_shutdown(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files:
        if f.tree is None:
            continue
        # receivers of .bind()/.listen() anywhere in the module are
        # listener sockets: shutdown() is invalid on them, close() is fine
        listeners: Set[str] = set()
        for n in ast.walk(f.tree):
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("bind", "listen")
            ):
                listeners.add(_unparse(n.func.value))

        # self.X attributes assigned from socket ctors anywhere in a class
        class_sockets: Dict[ast.ClassDef, Set[str]] = {}
        for fn, cls in iter_functions(f.tree):
            if cls is None:
                continue
            for n in ast.walk(fn):
                if isinstance(n, ast.Assign):
                    for name in _socket_targets(n):
                        if name.startswith("self."):
                            class_sockets.setdefault(cls, set()).add(name)

        for fn, cls in iter_functions(f.tree):
            sockets: Set[str] = set(class_sockets.get(cls, set()))
            for n in ast.walk(fn):
                if isinstance(n, ast.Assign):
                    sockets.update(_socket_targets(n))
            if not sockets:
                continue
            shutdown_lines: Dict[str, int] = {}
            for n in ast.walk(fn):
                if (
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "shutdown"
                ):
                    recv = _unparse(n.func.value)
                    shutdown_lines[recv] = min(
                        shutdown_lines.get(recv, n.lineno), n.lineno
                    )
            for n in ast.walk(fn):
                if not (
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "close"
                ):
                    continue
                recv = _unparse(n.func.value)
                if recv not in sockets or recv in listeners:
                    continue
                if recv in shutdown_lines and shutdown_lines[recv] <= n.lineno:
                    continue
                findings.append(
                    Finding(
                        "socket-shutdown",
                        f.path,
                        n.lineno,
                        f"{recv}.close() without a prior "
                        f"{recv}.shutdown(socket.SHUT_RDWR) in "
                        f"{getattr(fn, 'name', '?')}(); without the FIN the "
                        "peer's reader blocks in recv until its timeout "
                        "(listener sockets are exempt)",
                    )
                )
    return findings


def _spawn_kind(node: ast.Call) -> Optional[str]:
    name = dotted_name(node.func)
    last = name.rsplit(".", 1)[-1]
    if last == "Thread":
        return "thread"
    if last == "Process":
        return "process"
    return None


def _is_daemon_true(node: ast.Call) -> bool:
    for k in node.keywords:
        if k.arg == "daemon" and isinstance(k.value, ast.Constant):
            return bool(k.value.value)
    return False


def _has_reap_call(scope: ast.AST) -> bool:
    for n in ast.walk(scope):
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr in ("join", "terminate", "kill")
        ):
            return True
    return False


def _check_thread_lifecycle(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files:
        if f.tree is None:
            continue
        for fn, cls in iter_functions(f.tree):
            for n in ast.walk(fn):
                if not isinstance(n, ast.Call):
                    continue
                kind = _spawn_kind(n)
                if kind is None:
                    continue
                # daemon threads die with the process; daemon *processes*
                # still need reaping (SIGKILL at exit loses their sockets)
                if kind == "thread" and _is_daemon_true(n):
                    continue
                reaped = _has_reap_call(fn) or (
                    cls is not None and _has_reap_call(cls)
                )
                if not reaped:
                    findings.append(
                        Finding(
                            "thread-lifecycle",
                            f.path,
                            n.lineno,
                            f"{kind} spawned in {getattr(fn, 'name', '?')}() "
                            "with no join/terminate/kill in the function or "
                            "its class; every exit path must reap it or the "
                            "leak check fails later",
                        )
                    )
    return findings


register_rule(
    Rule(
        name="socket-shutdown",
        family="concurrency",
        description=(
            "connected sockets must shutdown(SHUT_RDWR) before close() so "
            "peers unblock; listener sockets are exempt"
        ),
        check=_check_socket_shutdown,
    )
)

register_rule(
    Rule(
        name="thread-lifecycle",
        family="concurrency",
        description=(
            "spawned threads/processes need a join/terminate/kill in scope "
            "(daemon threads exempt; daemon processes are not)"
        ),
        check=_check_thread_lifecycle,
    )
)
