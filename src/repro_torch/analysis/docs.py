"""Documentation references of the port (``docs.refs``; no ``torch``).

The counterpart of the JAX package's ``repro/analysis/docs.py``, over the
port's documents:

  (a) every backticked path in README's ``## PyTorch/CUDA port`` section
      and in the port's section of ``.claude/skills/verify/SKILL.md``
      exists, relative to the root, to ``src/repro_torch/`` or to
      ``src/repro_torch/kernels/`` (generated output, under ``build/`` or
      ``results/``, is exempt);
  (b) every ``python -m repro_torch.<module>`` named there is a module of
      the port;
  (c) every ``DESIGN.md`` section a port file cites (``src/repro_torch``,
      ``chip_smoke.py``, the port's scripts and tests, and those two
      sections) is a DESIGN.md heading.

A path is a backticked token with a ``/`` that ends in ``/`` or in a file
suffix of :data:`SUFFIXES`; a glob (``tests/test_torch_*.py``) must match
a file.  ``ROADMAP <ID>`` citations are not checked: ROADMAP.md is
rewritten every few PRs.
"""
from __future__ import annotations

import pathlib
import re
from typing import List, Tuple

from repro_torch.analysis import Finding, PassContext

SECTION = r"§(\d+(?:\.\d+)*)"
PORT_HEADING = "## PyTorch/CUDA port"
#: documents whose port section is checked, relative to the root
DOCUMENTS = ("README.md", ".claude/skills/verify/SKILL.md")
#: what a backticked path may end in
SUFFIXES = (".py", ".cu", ".cuh", ".h", ".json", ".jsonl", ".md", ".txt",
            ".gz", ".toml", ".cfg", ".ini", ".sh", ".csv", ".npz")
#: generated output: named by the documents, made at run time
GENERATED = ("build/", "results/")
#: where a relative path may resolve
BASES = ("", "src/repro_torch/", "src/repro_torch/kernels/")

_PATH_RE = re.compile(r"^[\w.*/-]+$")
_MODULE_RE = re.compile(r"python3? -m (repro_torch(?:\.\w+)+)")


def port_section(text: str) -> str:
    """The text under ``## PyTorch/CUDA port`` up to the next ``## ``
    heading (empty when there is none)."""
    m = re.search(rf"^{re.escape(PORT_HEADING)}.*?\n(.*?)(?=^## |\Z)", text,
                  re.M | re.S)
    return m.group(1) if m else ""


def path_spans(section: str) -> List[str]:
    """The backticked path tokens of ``section`` (see the module doc)."""
    out = []
    for span in re.findall(r"`([^`\n]+)`", section):
        for tok in span.split():
            tok = tok.strip("(),;:'\"")
            if "/" not in tok or not _PATH_RE.match(tok) or "//" in tok:
                continue
            if tok.endswith("/") or tok.endswith(SUFFIXES):
                out.append(tok)
    return out


def _exists(root: pathlib.Path, path: str) -> bool:
    for base in BASES:
        full = base + path
        if "*" in full:
            if any(root.glob(full)):
                return True
        elif (root / full).exists():
            return True
    return False


def check_sections(root: pathlib.Path) -> List[Tuple[str, str, str]]:
    """``(code, location, message)`` for every dangling path or module."""
    errors = []
    for doc in DOCUMENTS:
        path = root / doc
        if not path.exists():
            continue
        section = port_section(path.read_text())
        if not section:
            errors.append(("dangling-path", doc,
                           f"no '{PORT_HEADING}' section"))
            continue
        for span in path_spans(section):
            if span.startswith(GENERATED):
                continue
            if not _exists(root, span):
                errors.append(("dangling-path", f"{doc} port section",
                               f"`{span}` does not exist"))
        for mod in _MODULE_RE.findall(section):
            rel = root / "src" / pathlib.Path(*mod.split("."))
            if not (rel.with_suffix(".py").exists()
                    or (rel / "__init__.py").exists()):
                errors.append(("dangling-module", f"{doc} port section",
                               f"python -m {mod}: no such module"))
    return errors


def design_headings(root: pathlib.Path) -> set:
    """Section numbers with a real heading in DESIGN.md (## §2, ### §2.1)."""
    text = (root / "DESIGN.md").read_text()
    return set(re.findall(rf"^#{{2,}}\s+{SECTION}", text, re.M))


def port_files(root: pathlib.Path):
    yield from sorted((root / "src" / "repro_torch").rglob("*.py"))
    for rel in ("chip_smoke.py",):
        if (root / rel).exists():
            yield root / rel
    yield from sorted((root / "scripts").glob("*_torch.py"))
    yield from sorted((root / "tests").glob("test_torch_*.py"))


def check_design_refs(root: pathlib.Path) -> List[Tuple[str, str, str]]:
    headings = design_headings(root)
    if not headings:
        return [("dangling-ref", "DESIGN.md",
                 "no § headings found: parser broken?")]
    pat = re.compile(rf"DESIGN\.md\s+{SECTION}")
    errors = []

    def scan(loc_of, text):
        for lineno, line in enumerate(text.splitlines(), 1):
            for ref in pat.findall(line):
                if ref not in headings:
                    errors.append(("dangling-ref", loc_of(lineno),
                                   f"dangling reference DESIGN.md §{ref}"))

    for path in port_files(root):
        if "__pycache__" not in path.parts:
            rel = path.relative_to(root)
            scan(lambda n, rel=rel: f"{rel}:{n}",
                 path.read_text(errors="replace"))
    for doc in DOCUMENTS:
        if (root / doc).exists():
            scan(lambda n, doc=doc: f"{doc} port section",
                 port_section((root / doc).read_text()))
    return errors


def run_checks(root: pathlib.Path) -> List[Tuple[str, str, str]]:
    """Every problem; an empty list means the references resolve."""
    root = pathlib.Path(root)
    return check_sections(root) + check_design_refs(root)


def run_pass(ctx: PassContext) -> List[Finding]:
    """The registered pass (``docs.refs``)."""
    return [Finding(pass_name="docs.refs", code=code, severity="error",
                    location=loc, message=msg)
            for code, loc, msg in run_checks(ctx.root)]
