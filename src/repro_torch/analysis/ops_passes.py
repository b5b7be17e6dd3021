"""Per-program op budgets (``ops.budgets``): the port's counterpart of the
reference's ``hlo_passes.py``.

Each program of the inventory runs once under the op census
(``analysis/census.py``) and reduces to one flat row:

  ops_total                  every operation that moves bytes
  op_<name>                  those that track memory traffic and layout
                             churn (:data:`INTERESTING_OPS`)
  launch_<kernel>            calls of each hand-written kernel's wrapper
  host_reads                 reads back to the host
  collective_calls,          the mesh's collectives (``launch/mesh.Mesh
  collective_bytes_<kind>    .collectives()``), for the distributed rows

Rows are checked against the committed ``budgets.json`` as **ceilings**
(the reference's ``check_row``): only ``measured > budget`` fails, a
metric with no budget warns, a program with no row fails.  A row is keyed
``<program>@<device>``: the CPU's plain versions and the card's kernels
dispatch different operations, so each device has its own rows (41 on the
CPU, the ``@d4`` programs included; 35 on the card).  These rows count
eager PyTorch operations: they are not comparable with the reference's HLO
rows.  ``--update-budgets`` (``PassContext.update_budgets``) rewrites the
measured rows of the device it ran on, the explicit act a PR commits when
a budget legitimately moves.
"""
from __future__ import annotations

import json
from typing import Dict, List

from repro_torch.analysis import Finding, PassContext

#: operations budgeted one by one (everything else rides in ops_total)
INTERESTING_OPS = ("copy_", "_to_copy", "clone", "cat", "stack",
                   "index_select", "index_copy_", "index_add_",
                   "index_reduce_", "where", "nonzero", "full", "zeros")
#: the hand-written kernels' wrappers (``kernels.launch_site`` names)
KERNELS = ("minplus", "masked_matmul", "frontier", "ppr_push",
           "fused_visit", "threefry")


def row_of(r) -> Dict[str, int]:
    """One run (``dispatch_passes.Run``) as a flat metric row."""
    c = r.census
    row = {"ops_total": c.ops_total, "host_reads": c.host_reads,
           "collective_calls": 0}
    for op in INTERESTING_OPS:
        row[f"op_{op}"] = c.ops.get(op, 0)
    for k in KERNELS:
        row[f"launch_{k}"] = c.launches.get(k, 0)
    if r.collectives is not None:
        row["collective_calls"] = r.collectives["calls"]
        for kind, v in sorted(r.collectives["by_kind"].items()):
            row[f"collective_bytes_{kind}"] = v["bytes"]
    return row


def budget_key(program_key: str, device: str) -> str:
    return f"{program_key}@{device}"


def load_budgets(ctx: PassContext) -> Dict[str, Dict[str, int]]:
    if ctx.budgets_path.exists():
        return json.loads(ctx.budgets_path.read_text())
    return {}


def check_row(key: str, row: Dict[str, int],
              baseline: Dict[str, int]) -> List[Finding]:
    """One measured row against its committed ceiling."""
    findings: List[Finding] = []
    drift = []
    for metric, value in row.items():
        limit = baseline.get(metric)
        if limit is None:
            findings.append(Finding(
                pass_name="ops.budgets", code="unbudgeted-metric",
                severity="warning", location=key,
                message=f"metric {metric} ({value}) has no budget: refresh "
                        f"the row"))
        elif value > limit:
            drift.append(f"{metric}: {value} > {limit}")
    if drift:
        findings.append(Finding(
            pass_name="ops.budgets", code="budget-exceeded",
            severity="error", location=key,
            message="; ".join(drift) + ": the program grew past its "
                    "committed ceiling (if intended, rerun with "
                    "--update-budgets and commit the diff)"))
    else:
        findings.append(Finding(
            pass_name="ops.budgets", code="within-budget",
            severity="info", location=key,
            message=f"ops_total {row.get('ops_total')} <= "
                    f"{baseline.get('ops_total')}, host_reads "
                    f"{row.get('host_reads')} <= "
                    f"{baseline.get('host_reads')}"))
    return findings


def _shown(ctx: PassContext) -> str:
    """The budgets file, relative to the checkout where it lies in it."""
    try:
        return str(ctx.budgets_path.resolve().relative_to(
            ctx.root.resolve()))
    except ValueError:
        return str(ctx.budgets_path)


def run_pass(ctx: PassContext) -> List[Finding]:
    from repro_torch.analysis.programs import evaluate

    budgets = load_budgets(ctx)
    findings: List[Finding] = []
    measured: Dict[str, Dict[str, int]] = {}
    for e in evaluate(ctx):
        key = budget_key(e.key, ctx.device)
        measured[key] = e.row
        baseline = budgets.get(key)
        if baseline is None:
            if not ctx.update_budgets:
                findings.append(Finding(
                    pass_name="ops.budgets", code="no-baseline",
                    severity="error", location=key,
                    message="the program has no committed budget row: run "
                            "scripts/fppcheck_torch.py --ops "
                            "--update-budgets and commit budgets.json"))
            continue
        findings.extend(check_row(key, e.row, baseline))
    if ctx.update_budgets:
        merged = dict(budgets)
        merged.update(measured)
        ctx.budgets_path.write_text(
            json.dumps(merged, indent=2, sort_keys=True) + "\n")
        findings.append(Finding(
            pass_name="ops.budgets", code="budgets-updated",
            severity="info", location=_shown(ctx),
            message=f"rewrote {len(measured)} budget row(s); commit the "
                    f"diff"))
    return findings
