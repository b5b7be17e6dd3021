"""Dispatch hygiene of the graph programs (``dispatch.hygiene``): the
port's counterpart of the reference's ``jaxpr_passes.py``.

Each program of the inventory (``analysis/programs.py``) runs once under
the op census (``analysis/census.py``), and what it did is held to what it
declares:

  host-read-unreported      the census's reads back to the host differ from
                            the program's own count (``declared_reads``):
                            an unfused chunk reads once per exit test, a
                            round never.  The counterpart of a host callback
                            in a device loop: a read per visit that nothing
                            reports.
  host-read-in-fused-chunk  a fused chunk reads other than exactly once
  f64-promotion             an operation on the device with a float64 or
                            complex output (the contract is float32 values
                            and int32 counters)
  int64-state               an int64 state plane, buffer, metadata plane or
                            counter.  Index tensors may be int64 (the
                            partition id, the walk's ``pos``, ``part`` and
                            ``src``: they are not declared state); a
                            declared stand-in (``Program.allow64``, the
                            walk's uint32 hash) is ``allowlisted`` with its
                            reason
  counter-dtype             an exact-edge counter (or rw's ``steps``) is not
                            int32
  state-not-in-place        a state tensor comes back with another storage,
                            shape, dtype or stride than it went in with: the
                            port's contract is an update in place (the
                            counterpart of ``donation-unsafe``)

The reference's ``weak-output`` has no counterpart: torch has no weak
types (a Python scalar takes the other operand's dtype, and a tensor made
of literals alone has the default dtype), so it is no finding.

:func:`check_program` is the per-program unit that tests feed seeded
programs into.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.analysis import Finding, PassContext


def _meta(t) -> tuple:
    return (t.untyped_storage().data_ptr(), tuple(t.shape), t.dtype,
            tuple(t.stride()), t.storage_offset())


@dataclasses.dataclass
class Run:
    """One program's run: its output, the census, the in-place tensors'
    metadata before it, and its mesh's collectives."""
    out: object
    census: object
    before: Dict[str, tuple]
    collectives: Optional[dict] = None


def run(program, device) -> Run:
    """Run ``program`` once under a census on ``device``."""
    from repro_torch.analysis.census import run_counted

    before = {k: _meta(t) for k, t in program.in_place(
        program.args, None).items()}
    if program.mesh is not None:
        program.mesh.reset_counts()
    out, census = run_counted(program.fn, program.args, device)
    return Run(out, census, before, None if program.mesh is None
               else program.mesh.collectives())


def check_run(program, r: Run) -> List[Finding]:
    """The findings of one run (see the module docstring)."""
    import torch

    findings: List[Finding] = []

    def finding(code, severity, message):
        findings.append(Finding(pass_name="dispatch.hygiene", code=code,
                                severity=severity, location=program.key,
                                message=message))

    c = r.census
    declared = int(program.declared_reads(program.args, r.out))
    if c.host_reads != declared:
        finding("host-read-unreported", "error",
                f"{c.host_reads} read(s) back to the host "
                f"({dict(c.reads)}) where the program reports {declared}")
    if program.fused and c.host_reads != 1:
        finding("host-read-in-fused-chunk", "error",
                f"a fused chunk read the host {c.host_reads} time(s); its "
                f"contract is one launch and one read")
    if c.wide:
        finding("f64-promotion", "error",
                f"{sum(c.wide.values())} float64/complex output(s) on the "
                f"device: {sorted(c.wide)[:4]}; the contract is float32 "
                f"values and int32 counters")
    counters = program.counters(program.args, r.out)
    for name, t in {**program.state(program.args, r.out),
                    **counters}.items():
        if t.dtype != torch.int64:
            continue
        if name in program.allow64:
            finding("int64-state", "allowlisted",
                    f"{name} is int64: {program.allow64[name]}")
        else:
            finding("int64-state", "error",
                    f"{name} is int64; state, buffers, metadata and "
                    f"counters are float32 or int32 (only indices may be "
                    f"int64)")
    for name, t in counters.items():
        if t.dtype != torch.int32:
            finding("counter-dtype", "error",
                    f"exact-edge counter {name} is {t.dtype}, not the int32 "
                    f"contract")
    after = program.in_place(program.args, r.out)
    for name, meta in r.before.items():
        t = after.get(name)
        now = None if t is None else _meta(t)
        if now != meta:
            what = ("is gone" if now is None else
                    "has another storage" if now[0] != meta[0] else
                    f"changed (shape, dtype, stride, offset) "
                    f"{meta[1:]} -> {now[1:]}")
            finding("state-not-in-place", "error",
                    f"state {name!r} {what}: the state is updated in place")
    return findings


def check_program(program, device) -> List[Finding]:
    """Run ``program`` once on ``device`` and return its findings."""
    return check_run(program, run(program, device))


def run_pass(ctx: PassContext) -> List[Finding]:
    from repro_torch.analysis.programs import evaluate

    return [f for e in evaluate(ctx) for f in e.findings]
