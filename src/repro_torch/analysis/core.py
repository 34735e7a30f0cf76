"""Core of the port's static-analysis engine.

The port of ``repro.analysis.core``, with the same data types, rule
registry and fingerprints, so a finding's fingerprint is the same in both
packages.  The engine mirrors the repo's other registries (backends,
routers, link kinds, scenarios): rules are small objects registered by
name into ``RULES`` via :func:`register_rule`, and the CLI / tests look
them up the same way callers look up an execution backend.

A rule is a callable ``(Context) -> list[Finding]``.  Most rules are pure
AST walks over the parsed files in the context; two "runtime" rules
additionally import the ``repro_torch`` registries to cross-check the AST
against what actually registered (see ``rules_schema`` / ``rules_kernel``).

Suppression contract
--------------------
A finding on line L is suppressed by a comment on line L or L-1 of the
form::

    # repro: allow(rule-name) -- one-line justification

The justification is mandatory: an ``allow`` with no ``--`` justification
does NOT suppress anything and instead raises its own
``suppression-justification`` finding, so CI can require every waiver to
say why.
"""

from __future__ import annotations

import ast
import hashlib
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "SourceFile",
    "Suppression",
    "Context",
    "Rule",
    "RULES",
    "register_rule",
    "get_rule",
    "rule_names",
    "load_context",
    "run_rules",
    "analyze_source",
    "iter_functions",
    "function_body",
    "dotted_name",
]


# --------------------------------------------------------------------------
# findings

@dataclass
class Finding:
    """One rule violation at one source location.

    ``key`` is a content-based fingerprint component (hash of the stripped
    source line plus an occurrence index), so baseline entries survive
    unrelated line-number drift.
    """

    rule: str
    path: str
    line: int
    message: str
    key: str = ""
    suppressed: bool = False
    justification: str = ""

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}|{self.path}|{self.key}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "key": self.key,
        }

    def render(self) -> str:
        return f"{self.path}:{self.line} [{self.rule}] {self.message}"


_ALLOW_RE = re.compile(
    r"#\s*repro:\s*allow\(([a-z0-9_,\s-]+)\)(?:\s*--\s*(.*))?\s*$"
)


@dataclass
class Suppression:
    path: str
    line: int
    rules: Tuple[str, ...]
    justification: str

    def covers(self, finding: Finding) -> bool:
        if finding.path != self.path:
            return False
        if finding.line not in (self.line, self.line + 1):
            return False
        return finding.rule in self.rules or "*" in self.rules


@dataclass
class SourceFile:
    path: str  # repo-relative, forward slashes
    source: str
    tree: Optional[ast.AST]  # None when the file failed to parse
    parse_error: str = ""

    @property
    def lines(self) -> List[str]:
        return self.source.splitlines()

    def suppressions(self) -> List[Suppression]:
        out = []
        for line, text in self._comments():
            m = _ALLOW_RE.search(text)
            if m:
                rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
                out.append(
                    Suppression(self.path, line, rules, (m.group(2) or "").strip())
                )
        return out

    def _comments(self) -> List[Tuple[int, str]]:
        """(line, text) for real comment tokens — an allow() example inside
        a docstring or string literal must not count as a waiver."""
        import io
        import tokenize

        try:
            return [
                (tok.start[0], tok.string)
                for tok in tokenize.generate_tokens(
                    io.StringIO(self.source).readline
                )
                if tok.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # unparseable file: fall back to a line scan so a waiver next
            # to the syntax finding still works
            return list(enumerate(self.lines, start=1))


@dataclass
class Context:
    """Everything a rule may look at: parsed files plus the repo root.

    ``runtime`` gates the rules that import the ``repro_torch`` registries;
    fixture tests run pure-AST rules with ``runtime=False`` so analysing a
    snippet never builds a registry or a plan.
    """

    files: List[SourceFile]
    root: Path
    runtime: bool = True

    def file(self, path: str) -> Optional[SourceFile]:
        for f in self.files:
            if f.path == path:
                return f
        return None


# --------------------------------------------------------------------------
# rule registry (same shape as core.backends / serving.fleet routers)

@dataclass(frozen=True)
class Rule:
    name: str
    family: str  # timing | rng | concurrency | schema | kernel | core
    description: str
    check: Callable[[Context], List[Finding]]


RULES: Dict[str, Rule] = {}


def register_rule(rule: Rule) -> Rule:
    if rule.name in RULES:
        raise ValueError(f"duplicate rule name {rule.name!r}")
    RULES[rule.name] = rule
    return rule


def get_rule(name: str) -> Rule:
    try:
        return RULES[name]
    except KeyError:
        raise KeyError(
            f"unknown rule {name!r}; known: {', '.join(sorted(RULES))}"
        ) from None


def rule_names() -> List[str]:
    return sorted(RULES)


# --------------------------------------------------------------------------
# AST helpers shared by the rule modules

def dotted_name(node: ast.AST) -> str:
    """Best-effort dotted source text for a Name/Attribute chain."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        return dotted_name(node.func)
    return ""


def iter_functions(
    tree: ast.AST,
) -> Iterator[Tuple[ast.AST, Optional[ast.ClassDef]]]:
    """Yield (function_def, enclosing_class) pairs, innermost included."""

    def walk(node: ast.AST, cls: Optional[ast.ClassDef]) -> Iterator:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, child)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, cls
                yield from walk(child, cls)
            else:
                yield from walk(child, cls)

    yield from walk(tree, None)


def function_body(fn: ast.AST) -> List[ast.AST]:
    """All nodes in a function, excluding nested function/class bodies.

    Nested defs are analysed on their own by :func:`iter_functions`; a
    block call inside a helper closure must not satisfy the outer timing
    window.
    """
    out: List[ast.AST] = []

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            out.append(child)
            walk(child)

    walk(fn)
    return out


def _finding_key(rule: str, file: SourceFile, line: int, seen: Dict[str, int]) -> str:
    lines = file.lines
    text = lines[line - 1].strip() if 0 < line <= len(lines) else ""
    base = f"{rule}|{text}"
    idx = seen.get(base, 0)
    seen[base] = idx + 1
    return hashlib.sha1(f"{base}|{idx}".encode()).hexdigest()[:12]


# --------------------------------------------------------------------------
# entry points

def load_context(
    paths: Sequence[str], root: Path, runtime: bool = True
) -> Context:
    files: List[SourceFile] = []
    for p in paths:
        full = (root / p).resolve()
        if full.is_dir():
            candidates = sorted(full.rglob("*.py"))
        elif full.suffix == ".py":
            candidates = [full]
        else:
            continue
        for c in candidates:
            rel = c.relative_to(root).as_posix()
            source = c.read_text()
            try:
                tree: Optional[ast.AST] = ast.parse(source, filename=rel)
                err = ""
            except SyntaxError as e:
                tree, err = None, f"line {e.lineno}: {e.msg}"
            files.append(SourceFile(rel, source, tree, err))
    return Context(files=files, root=root, runtime=runtime)


def run_rules(
    ctx: Context, rules: Optional[Sequence[str]] = None
) -> List[Finding]:
    """Run rules, fingerprint findings, and apply suppression comments."""
    selected = [get_rule(n) for n in (rules if rules is not None else rule_names())]
    findings: List[Finding] = []

    # unparseable files are findings, not crashes
    for f in ctx.files:
        if f.tree is None:
            findings.append(
                Finding("syntax", f.path, 1, f"file does not parse: {f.parse_error}")
            )

    for rule in selected:
        findings.extend(rule.check(ctx))

    suppressions: List[Suppression] = []
    for f in ctx.files:
        suppressions.extend(f.suppressions())

    for s in suppressions:
        if not s.justification:
            findings.append(
                Finding(
                    "suppression-justification",
                    s.path,
                    s.line,
                    "repro: allow(...) without a '-- justification'; "
                    "the waiver is ignored until it says why",
                )
            )

    for fi in findings:
        for s in suppressions:
            if s.justification and s.covers(fi):
                fi.suppressed = True
                fi.justification = s.justification
                break

    findings.sort(key=lambda fi: (fi.path, fi.line, fi.rule))
    seen: Dict[str, int] = {}
    by_path = {f.path: f for f in ctx.files}
    for fi in findings:
        src = by_path.get(fi.path)
        fi.key = (
            _finding_key(fi.rule, src, fi.line, seen)
            if src
            else hashlib.sha1(fi.fingerprint.encode()).hexdigest()[:12]
        )
    return findings


def analyze_source(
    source: str,
    path: str = "snippet.py",
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Analyse a single in-memory snippet (the fixture-test entry point).

    Runs with ``runtime=False`` so the registry and shared-memory audits
    only perform their AST cross-reference half.
    """
    try:
        tree: Optional[ast.AST] = ast.parse(source, filename=path)
        err = ""
    except SyntaxError as e:
        tree, err = None, f"line {e.lineno}: {e.msg}"
    ctx = Context(
        files=[SourceFile(path, source, tree, err)],
        root=Path("."),
        runtime=False,
    )
    return run_rules(ctx, rules=rules)


# two checks live in run_rules itself (they apply to every run regardless
# of rule selection); registered here so --list-rules documents them
register_rule(
    Rule(
        name="syntax",
        family="core",
        description="every scanned file parses under the CI interpreter",
        check=lambda ctx: [],  # emitted by run_rules from parse errors
    )
)
register_rule(
    Rule(
        name="suppression-justification",
        family="core",
        description=(
            "every '# repro: allow(...)' waiver carries a '-- justification'"
        ),
        check=lambda ctx: [],  # emitted by run_rules from the comment scan
    )
)


# the registry ships full: importing repro_torch.analysis pulls in every rule
# module (mirrors how serving.scenario registers its builtin scenarios on
# import)
def _register_builtin_rules() -> None:
    from repro_torch.analysis import (  # noqa: F401
        rules_timing,
        rules_rng,
        rules_concurrency,
        rules_schema,
        rules_kernel,
    )
