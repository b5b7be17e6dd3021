"""AST lint passes over ``src/repro_torch`` (no ``torch`` import).

  ast.asserts    bare ``assert`` on a library path.  Asserts vanish under
                 ``python -O`` and give the caller a context-free
                 ``AssertionError``; library code raises ``ValueError`` or
                 ``RuntimeError`` with a message.  Test directories are
                 exempt; a deliberate invariant stays with an inline
                 ``# fppcheck: allow-assert``.

  ast.host-read  a read back to the host lexically inside a host ``for`` or
                 ``while`` loop of ``core/``, ``fpp/`` or ``serve/``: a call
                 of ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()``,
                 or ``bool(...)``, ``int(...)`` or ``float(...)`` around a
                 reduction (``.any()``, ``.all()``, ``.sum()``, ``.max()``,
                 ``.min()``, ``.item()``).  In eager PyTorch every
                 operation dispatches, so a dispatch per iteration says
                 nothing; a read per iteration stalls the host on the card
                 each time, which is what the K-visit megastep exists to
                 remove.  A nested ``def`` or ``lambda`` starts a new
                 context (the reference's rule).  A deliberate read carries
                 ``# fppcheck: allow-host-read: <reason>`` on a line of
                 its statement or in the comment block right above it; the
                 marker without a reason is itself an error.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import List

from repro_torch.analysis import Finding, PassContext

#: directory names whose asserts are exempt wholesale
ASSERT_EXEMPT_DIRS = {"tests", "__pycache__"}

ALLOW_ASSERT = "fppcheck: allow-assert"
ALLOW_HOST_READ = "fppcheck: allow-host-read"
#: the marker and its reason: anything after the colon but blanks
_ALLOW_RE = re.compile(re.escape(ALLOW_HOST_READ) + r"(?::\s*(\S.*))?")

PORT = "src/repro_torch"
#: the subtrees ``ast.host-read`` polices: the dataflow core, the session
#: and streaming layer, and the serving lanes
HOST_READ_SUBDIRS = ("src/repro_torch/core", "src/repro_torch/fpp",
                     "src/repro_torch/serve")
#: tensor methods that read the device back to the host
READ_METHODS = {"item", "tolist", "cpu", "numpy"}
#: reductions whose ``bool``/``int``/``float`` is a read
REDUCTIONS = {"any", "all", "sum", "max", "min", "item"}
SCALAR_CASTS = {"bool", "int", "float"}


def _py_files(root: pathlib.Path, sub: str = PORT):
    base = root / sub
    for path in sorted(base.rglob("*.py")):
        parts = set(p.name for p in path.relative_to(base).parents)
        if not parts & ASSERT_EXEMPT_DIRS:
            yield path


def _line_has(lines, lineno: int, marker: str) -> bool:
    return 1 <= lineno <= len(lines) and marker in lines[lineno - 1]


def check_asserts(ctx: PassContext) -> List[Finding]:
    findings = []
    for path in _py_files(ctx.root):
        text = path.read_text()
        lines = text.splitlines()
        rel = path.relative_to(ctx.root)
        for node in ast.walk(ast.parse(text, filename=str(path))):
            if isinstance(node, ast.Assert) and not _line_has(
                    lines, node.lineno, ALLOW_ASSERT):
                findings.append(Finding(
                    pass_name="ast.asserts", code="bare-assert",
                    severity="error", location=f"{rel}:{node.lineno}",
                    message="bare assert on a library path: raise "
                            "ValueError/RuntimeError with a message (or "
                            f"annotate '# {ALLOW_ASSERT}')"))
    return findings


def _read_call(node: ast.Call):
    """The rendered read if ``node`` is one (see the module doc)."""
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr in READ_METHODS:
        return f".{fn.attr}()"
    if (isinstance(fn, ast.Name) and fn.id in SCALAR_CASTS
            and len(node.args) == 1 and isinstance(node.args[0], ast.Call)
            and isinstance(node.args[0].func, ast.Attribute)
            and node.args[0].func.attr in REDUCTIONS):
        return f"{fn.id}(.{node.args[0].func.attr}())"
    return None


class _HostLoopReads(ast.NodeVisitor):
    """Reads lexically inside host for/while loops; a nested def or
    lambda resets the loop context."""

    def __init__(self):
        self.loop_depth = 0
        self.stmt = None
        self.hits = []   # (statement, rendered read)

    def visit(self, node):
        if not isinstance(node, ast.stmt):
            return super().visit(node)
        saved, self.stmt = self.stmt, node
        try:
            return super().visit(node)
        finally:
            self.stmt = saved

    def visit_FunctionDef(self, node):
        saved, self.loop_depth = self.loop_depth, 0
        self.generic_visit(node)
        self.loop_depth = saved

    visit_AsyncFunctionDef = visit_Lambda = visit_FunctionDef

    def visit_For(self, node):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_AsyncFor = visit_While = visit_For

    def visit_Call(self, node):
        if self.loop_depth > 0:
            read = _read_call(node)
            if read is not None:
                self.hits.append((self.stmt, read))
        self.generic_visit(node)


def _reason(lines, stmt):
    """The allow marker's reason on one of the lines of statement ``stmt``
    (a compound statement's header only) or in the comment block right
    above it: None where there is no marker, "" where it has no reason."""
    first = stmt.lineno
    body = getattr(stmt, "body", None)
    last = (body[0].lineno - 1 if isinstance(body, list) and body
            else stmt.end_lineno or stmt.lineno)
    while first > 1 and lines[first - 2].lstrip().startswith("#"):
        first -= 1
    for lineno in range(first, last + 1):
        if 1 <= lineno <= len(lines):
            m = _ALLOW_RE.search(lines[lineno - 1])
            if m:
                return (m.group(1) or "").strip()
    return None


def check_host_reads(ctx: PassContext) -> List[Finding]:
    findings = []
    for sub in HOST_READ_SUBDIRS:
        for path in _py_files(ctx.root, sub):
            findings.extend(_host_reads_in(ctx, path))
    return findings


def _host_reads_in(ctx: PassContext, path: pathlib.Path) -> List[Finding]:
    text = path.read_text()
    lines = text.splitlines()
    rel = path.relative_to(ctx.root)
    out = []
    for lineno, line in enumerate(lines, 1):
        m = _ALLOW_RE.search(line)
        if m and not (m.group(1) or "").strip():
            out.append(Finding(
                pass_name="ast.host-read", code="allow-without-reason",
                severity="error", location=f"{rel}:{lineno}",
                message=f"'# {ALLOW_HOST_READ}' needs a reason: "
                        f"'# {ALLOW_HOST_READ}: <why this read stays>'"))
    visitor = _HostLoopReads()
    visitor.visit(ast.parse(text, filename=str(path)))
    by_line = {}      # one finding a line: x.cpu().numpy() is one read
    for stmt, read in visitor.hits:
        if _reason(lines, stmt) is None:
            by_line.setdefault(stmt.lineno, []).append(read)
    for lineno, reads in sorted(by_line.items()):
        out.append(Finding(
            pass_name="ast.host-read", code="host-read-in-loop",
            severity="error", location=f"{rel}:{lineno}",
            message=f"{', '.join(reads)} inside a host loop: a read back "
                    "to the host each iteration; fold it into one read, or "
                    f"annotate '# {ALLOW_HOST_READ}: <reason>'"))
    return out
