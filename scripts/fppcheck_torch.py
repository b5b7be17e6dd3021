#!/usr/bin/env python
"""fppcheck_torch — the one CLI over the port's static-analysis layer.

    python scripts/fppcheck_torch.py --all                # on the card
    python scripts/fppcheck_torch.py --all --device cpu   # on the CPU
    python scripts/fppcheck_torch.py --ast --docs         # no torch needed
    python scripts/fppcheck_torch.py --ops --update-budgets --device cpu
    python scripts/fppcheck_torch.py --all --report out.json

Families (``repro_torch.analysis``): ast, docs, kernels, dispatch, ops.
The dispatch and ops families run the 41 graph programs of
``analysis/programs.py`` on ``--device`` (``cuda`` unless ``cpu`` is
given; with no card it raises rather than fall back to the CPU).  On the
CPU the ``@d4`` programs run in a spawned world of four gloo ranks.  Exit
code 1 on any error finding (a budget exceeded, a bare assert, an
unreported host read, ...); allowlisted, warning and info findings never
fail.  ``--update-budgets`` rewrites the device's rows of
``analysis/budgets.json``: commit the diff.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import FAMILIES, PassContext, run_passes  # noqa: E402

#: families that run programs on the device
DEVICE_FAMILIES = ("dispatch", "ops")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for fam in FAMILIES:
        ap.add_argument(f"--{fam}", action="store_true",
                        help=f"run the {fam} pass family "
                             f"({', '.join(FAMILIES[fam])})")
    ap.add_argument("--all", action="store_true", help="run every family")
    ap.add_argument("--only", default=None, metavar="SUBSTR",
                    help="filter the dispatch/ops program keys by substring "
                         "(e.g. 'engine/', 'distributed/sssp')")
    ap.add_argument("--update-budgets", action="store_true",
                    help="rewrite the device's rows of "
                         "analysis/budgets.json from the measured ones")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="also write the full report as JSON")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the dispatch/ops programs run "
                         "(default: cuda)")
    args = ap.parse_args(argv)

    families = [f for f in FAMILIES if args.all or getattr(args, f)]
    if not families:
        ap.error("pick at least one pass family (or --all)")
    env = {"argv": sys.argv[1:] if argv is None else list(argv),
           "device": args.device}
    if any(f in DEVICE_FAMILIES for f in families):
        import torch
        if args.device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "fppcheck_torch: --device cuda needs a CUDA card and "
                    "none is available; pass --device cpu to run the "
                    "programs on the CPU")
            env["card"] = torch.cuda.get_device_name(0)
        env["torch"] = torch.__version__

    ctx = PassContext(root=ROOT, update_budgets=args.update_budgets,
                      only_programs=args.only, device=args.device)
    report = run_passes([n for fam in families for n in FAMILIES[fam]],
                        ctx)
    report.env = env
    print(report.render())
    if args.report:
        report.write(args.report)
        print(f"fppcheck: report written to {args.report}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
