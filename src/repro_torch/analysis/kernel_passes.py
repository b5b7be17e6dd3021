"""Kernel contract passes: the port's counterpart of the JAX package's
``repro/analysis/pallas_passes.py``, over the Hopper kernels.

    PYTHONPATH=src python -c "from repro_torch.analysis import kernel_passes as k; k.main()"

prints every finding and exits 1 on an ``error``.

:func:`check_contracts` holds every declared
``kernels/contract.KernelContract`` (:func:`check_contract`) against
``fpp/planner.MemoryModel``, without building or launching a kernel:

  * tile divisibility: each output's full dims divide into whole tiles;
  * grid coverage: a ``"once"`` output's tiles are the grid's cells, an
    ``"accum"`` output is one block;
  * limits: dynamic shared memory within ``MemoryModel.smem_bytes``
    (232,448 B, one thread block's), at most 1,024 threads a block, a
    cluster of at most 8 (the portable size), a persistent launch no wider
    than its grid;
  * the planner's model for *wired* graph kernels: a direct kernel's
    shared memory within ``MemoryModel.working_set`` of its (B, Q), the
    fused visit's equal to ``MemoryModel.fused_working_set`` (the planner
    admits a plan by that number, so it must be what the launch asks for).

:func:`check_reachability` checks each package's ``wired`` claim against
the import graph of ``src/repro_torch`` (AST level).  A module outside
``kernels/`` dispatches a package when it reaches one of its names other
than the launch counters (``LAUNCHES``, ``reset_launches``): a
``from``-import of such a name, or such an attribute of the imported
module.  ``launch/distributed.py`` imports every package only to read and
reset its counters, which is no dispatch: so B3 (``frontier``) and B4
(``ppr_push``), whose tiles run only inside the fused visit, are declared
``wired=False`` with a note, and a claim of either kind that the graph
contradicts is an error.  ``core/randomwalk`` must stay dispatched (the
reference's ruling).

The passes report; they change no planner decision.
"""
from __future__ import annotations

import ast
import pathlib
import sys
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.analysis import Finding, PassContext

PKG = "repro_torch.kernels"
#: names of a kernel package that only count its launches
COUNTERS = frozenset({"LAUNCHES", "reset_launches"})
MAX_THREADS, MAX_CLUSTER = 1024, 8


def check_contract(c, mem) -> List[Finding]:
    """Validate one contract against one ``MemoryModel``."""
    out = []
    loc = f"{c.module} ({c.kernel})"

    def err(code, msg):
        out.append(Finding("kernels.contracts", code, "error", loc, msg))

    for t in c.out_tiles:
        if not t.divisible():
            err("tile-divisibility", f"output {t.name}: block {t.block} "
                f"does not divide its full shape {t.full}")
        elif t.update == "once" and t.num_blocks() != c.grid_size():
            err("grid-coverage", f"output {t.name}: the grid {c.grid} has "
                f"{c.grid_size()} cells but the tiling {t.num_blocks()} "
                f"blocks; each element must be written exactly once")
        elif t.update == "accum" and t.num_blocks() != 1:
            err("grid-coverage", f"output {t.name}: update='accum' promises "
                f"one shared block, the tiling has {t.num_blocks()}")
    if c.smem_bytes > mem.smem_bytes:
        err("smem-overflow", f"{c.smem_bytes} B of dynamic shared memory "
            f"exceed a thread block's {mem.smem_bytes} B")
    if not 0 < c.threads <= MAX_THREADS:
        err("threads", f"{c.threads} threads a block; at most "
            f"{MAX_THREADS}")
    if not 1 <= c.cluster <= MAX_CLUSTER:
        err("cluster", f"a cluster of {c.cluster}; the portable most is "
            f"{MAX_CLUSTER}")
    if c.ctas is not None and not 0 < c.ctas <= c.grid_size():
        err("ctas", f"{c.ctas} thread blocks walk a grid of "
            f"{c.grid_size()} cells")
    if out or not c.wired or c.block_size is None:
        return out
    B, Q = c.block_size, c.num_queries
    if c.fused_model:
        ws = mem.fused_working_set(B, Q, c.num_planes)
        ok = c.smem_bytes == ws
        model = f"fused working set {ws} B (B={B}, Q={Q}, np={c.num_planes})"
        code = "model-mismatch"
    else:
        ws = mem.working_set(B, Q)
        ok = c.smem_bytes <= ws
        model = f"working set {ws} B (B={B}, Q={Q})"
        code = "model-overflow"
    if not ok:
        err(code, f"{c.smem_bytes} B of shared memory against the "
            f"planner's {model}")
    else:
        out.append(Finding("kernels.contracts", "footprint", "info", loc,
                           f"{c.smem_bytes} B within the planner's {model}"))
    return out


def check_contracts(ctx: Optional[PassContext] = None,
                    contracts: Optional[Iterable] = None) -> List[Finding]:
    """:func:`check_contract` of every contract (default: every
    package's)."""
    from repro_torch.fpp.planner import MemoryModel
    from repro_torch.kernels.contract import all_contracts

    mem = MemoryModel()
    return [f for c in (all_contracts() if contracts is None else contracts)
            for f in check_contract(c, mem)]


def _uses(tree) -> Set[str]:
    """The dotted names a module reaches: each module it imports, and
    ``module.name`` for each name it takes from one (a ``from``-import, or
    an attribute of an imported module's alias); a module imported and
    never read adds only its own name."""
    aliases: Dict[str, str] = {}
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                names.add(a.name)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
            for a in node.names:
                full = f"{node.module}.{a.name}"
                aliases[a.asname or a.name] = full
                names.add(full)
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in aliases:
            names.add(f"{aliases[node.value.id]}.{node.attr}")
    return names


def import_graph(root: pathlib.Path) -> Dict[str, Set[str]]:
    """``{path relative to root: the names it reaches}`` over
    ``src/repro_torch``."""
    base = pathlib.Path(root) / "src" / "repro_torch"
    return {str(p.relative_to(root)): _uses(ast.parse(p.read_text(),
                                                      filename=str(p)))
            for p in sorted(base.rglob("*.py"))
            if "__pycache__" not in p.parts}


def dispatchers(root: pathlib.Path, graph: Dict[str, Set[str]],
                pkg: str) -> List[str]:
    """The files outside ``kernels/`` that reach a name of kernel package
    ``pkg`` (of one of its modules) other than its counters."""
    prefix = f"{PKG}.{pkg}"
    here = pathlib.Path(root) / "src" / "repro_torch" / "kernels" / pkg
    modules = {prefix} | {f"{prefix}.{p.stem}" for p in here.glob("*.py")}
    hits = []
    for rel, names in graph.items():
        if rel.startswith("src/repro_torch/kernels/"):
            continue
        for n in names:
            head, _, last = n.rpartition(".")
            if n.startswith(prefix + ".") and head in modules and \
                    n not in modules and last not in COUNTERS:
                hits.append(rel)
                break
    return hits


def check_reachability(ctx: Optional[PassContext] = None,
                       contracts: Optional[Iterable] = None
                       ) -> List[Finding]:
    """Each package's ``wired`` claim against the import graph of
    ``ctx.root``; ``core/randomwalk`` stays dispatched."""
    from repro_torch.kernels.contract import KERNEL_PACKAGES, all_contracts

    ctx = ctx or PassContext()
    graph = import_graph(ctx.root)
    claim = {pkg: False for pkg in KERNEL_PACKAGES}
    notes: Dict[str, str] = {}
    for c in (all_contracts() if contracts is None else contracts):
        claim[c.name] = claim[c.name] or c.wired
        if not c.wired:
            notes[c.name] = c.note
    out = []
    for pkg in KERNEL_PACKAGES:
        hits = dispatchers(ctx.root, graph, pkg)
        loc = f"src/repro_torch/kernels/{pkg}"

        def add(code, severity, msg):
            out.append(Finding("kernels.reachability", code, severity, loc,
                               msg))
        if claim[pkg] and not hits:
            add("stale-wired-claim", "error", "the contract claims "
                "wired=True but no module outside kernels/ dispatches the "
                "package: fix the dispatch or declare the kernel dead with "
                "a note")
        elif not claim[pkg] and hits:
            add("stale-dead-claim", "error", f"the contract claims "
                f"wired=False but {sorted(hits)} dispatch it: flip the claim")
        elif not claim[pkg] and not notes.get(pkg):
            add("dead-no-reason", "error", "a dead kernel with no ruling: "
                "wired=False needs a contract note naming the plan")
        elif not claim[pkg]:
            add("dead-kernel", "allowlisted", f"dispatched by no path "
                f"({notes[pkg]})")
        else:
            add("wired", "info", f"dispatched by {sorted(hits)}")
    rw = "repro_torch.core.randomwalk"
    users = sorted(rel for rel, names in graph.items()
                   if rel != "src/repro_torch/core/randomwalk.py"
                   and any(n == rw or n.startswith(rw + ".") for n in names))
    loc = "src/repro_torch/core/randomwalk.py"
    if users:
        out.append(Finding("kernels.reachability", "wired", "info", loc,
                           f"dispatched by {users}"))
    else:
        out.append(Finding("kernels.reachability", "dead-module", "error",
                           loc, "core/randomwalk lost its dispatch "
                           "(core/queries.run_rw, fpp/session.random_walks)"))
    return out


def run(ctx: Optional[PassContext] = None) -> List[Finding]:
    """Both passes."""
    ctx = ctx or PassContext()
    return check_contracts(ctx) + check_reachability(ctx)


def main() -> int:
    findings = run()
    for f in findings:
        print(f.render())
    errors = sum(f.severity == "error" for f in findings)
    print(f"kernel passes: {'FAIL' if errors else 'OK'} ({errors} errors, "
          f"{len(findings)} findings)")
    if errors:
        sys.exit(1)
    return 0
