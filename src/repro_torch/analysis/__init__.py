"""fppcheck for the port: the static-analysis layer over ``src/repro_torch``.

The counterpart of the JAX package's ``repro.analysis``, as five pass
families:

  ast       source lints (``ast_passes.py``): no bare ``assert`` on a
            library path, no read back to the host inside a host loop of
            ``core/``, ``fpp/`` or ``serve/`` without a stated reason
  docs      documentation references (``docs.py``): the paths, modules and
            scripts the port's documents name exist, and every
            ``DESIGN.md`` section a port file cites is a heading
  kernels   the Hopper kernels' static contracts and the dispatch
            reachability of their packages (``kernel_passes.py``)
  dispatch  hygiene of the 41 graph programs (``dispatch_passes.py``): each
            runs once under an op census, and its host reads, dtypes,
            counters and in-place state are held to the program's own
            declarations (the counterpart of the reference's jaxpr pass)
  ops       per-program op, launch, host-read and collective budgets
            against the committed ``budgets.json`` ceilings
            (``ops_passes.py``, the counterpart of the HLO budgets)

``scripts/fppcheck_torch.py`` is the one CLI.  The ``ast`` and ``docs``
families import no ``torch``: the registry resolves pass modules lazily.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib
from typing import Callable, Dict, List, Optional, Tuple

#: severity ladder: only "error" fails.  "allowlisted" is a warning with an
#: explicit standing excuse (a dead kernel's ruling).
SEVERITIES = ("error", "warning", "allowlisted", "info")


def repo_root() -> pathlib.Path:
    """The checkout this package sits in (``.../src/repro_torch/analysis``)."""
    return pathlib.Path(__file__).resolve().parents[3]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One fact a pass established about the code."""
    pass_name: str     # e.g. "kernels.contracts"
    code: str          # a stable tag, e.g. "grid-coverage"
    severity: str      # one of SEVERITIES
    location: str      # "path:line", a module, or a program key
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; one of "
                             f"{SEVERITIES}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"[{self.severity:>11}] {self.pass_name} {self.code} @ "
                f"{self.location}: {self.message}")


@dataclasses.dataclass
class PassContext:
    """What a pass may need: the checkout whose ``src/repro_torch`` it
    reads, the budgets file and whether to rewrite it, a substring filter
    over program keys, and the device the programs run on (``"cuda"``
    unless the caller asks for ``"cpu"``)."""
    root: pathlib.Path = dataclasses.field(default_factory=repo_root)
    update_budgets: bool = False
    budgets_path: Optional[pathlib.Path] = None
    only_programs: Optional[str] = None
    device: str = "cuda"
    #: measured programs, shared by the dispatch and ops passes of one run
    cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.root = pathlib.Path(self.root)
        if self.budgets_path is None:
            self.budgets_path = pathlib.Path(__file__).with_name(
                "budgets.json")
        self.budgets_path = pathlib.Path(self.budgets_path)


@dataclasses.dataclass
class Report:
    """The result of one fppcheck invocation."""
    findings: List[Finding]
    passes_run: List[str]
    env: dict = dataclasses.field(default_factory=dict)

    def count(self, severity: str) -> int:
        return sum(1 for f in self.findings if f.severity == severity)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def as_dict(self) -> dict:
        return {
            "passes_run": list(self.passes_run),
            "env": dict(self.env),
            "counts": {s: self.count(s) for s in SEVERITIES},
            "findings": [f.as_dict() for f in self.findings],
            "ok": self.ok,
        }

    def write(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.as_dict(), indent=2,
                                   sort_keys=True) + "\n")

    def render(self) -> str:
        lines = [f"fppcheck: ran {len(self.passes_run)} pass(es): "
                 f"{', '.join(self.passes_run)}"]
        for sev in SEVERITIES:
            for f in self.findings:
                if f.severity == sev:
                    lines.append("  " + f.render())
        counts = ", ".join(f"{self.count(s)} {s}" for s in SEVERITIES
                           if self.count(s))
        lines.append(f"fppcheck: {'FAIL' if self.errors else 'OK'}"
                     f"{' — ' + counts if counts else ' — no findings'}")
        return "\n".join(lines)


#: registry: pass name -> (module, function), imported lazily
PASSES: Dict[str, Tuple[str, str]] = {
    "ast.asserts": ("repro_torch.analysis.ast_passes", "check_asserts"),
    "ast.host-read": ("repro_torch.analysis.ast_passes",
                      "check_host_reads"),
    "docs.refs": ("repro_torch.analysis.docs", "run_pass"),
    "kernels.contracts": ("repro_torch.analysis.kernel_passes",
                          "check_contracts"),
    "kernels.reachability": ("repro_torch.analysis.kernel_passes",
                             "check_reachability"),
    "dispatch.hygiene": ("repro_torch.analysis.dispatch_passes", "run_pass"),
    "ops.budgets": ("repro_torch.analysis.ops_passes", "run_pass"),
}

#: pass families as the CLI exposes them (``--<family>``)
FAMILIES: Dict[str, Tuple[str, ...]] = {
    "ast": ("ast.asserts", "ast.host-read"),
    "docs": ("docs.refs",),
    "kernels": ("kernels.contracts", "kernels.reachability"),
    "dispatch": ("dispatch.hygiene",),
    "ops": ("ops.budgets",),
}


def resolve_pass(name: str) -> Callable[[PassContext], List[Finding]]:
    mod_name, fn_name = PASSES[name]
    return getattr(importlib.import_module(mod_name), fn_name)


def run_passes(names, ctx: Optional[PassContext] = None) -> Report:
    """Run the named passes in order and collect one Report."""
    ctx = ctx or PassContext()
    findings: List[Finding] = []
    ran = []
    for name in names:
        if name not in PASSES:
            raise ValueError(f"unknown pass {name!r}; one of "
                             f"{sorted(PASSES)}")
        findings.extend(resolve_pass(name)(ctx))
        ran.append(name)
    return Report(findings=findings, passes_run=ran)
