"""fppcheck of the port (``repro_torch.analysis``), on the CPU.

One counterpart for each test of ``tests/test_fppcheck.py``: each pass is
fed a seeded fault on a ``tmp_path`` tree or a seeded program and must
catch it with its code (a bare assert, a read back to the host in a host
loop, a dangling path or section, a tile that does not divide, an
unreported host read, a float64 output, a counter that is not int32, state
that is not updated in place, a row past its ceiling), and the real tree
stays clean.  Beyond those: every program of the CPU inventory clean and
within its committed row, the six ``@d4`` programs in one spawned world
of four gloo ranks, one chunk's counters of ``engine/sssp``, ``engine/ppr``
and ``engine/rw`` against the reference's on the same input, the census
seeing a kernel wrapper as one launch, and the CLI's device rule.
"""
import dataclasses
import importlib.util
import json
import pathlib
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (Finding, PassContext, Report,  # noqa: E402
                                  repo_root, run_passes)
from repro_torch.analysis import kernel_passes as kp  # noqa: E402
from repro_torch.analysis import programs as inv  # noqa: E402
from repro_torch.analysis.ast_passes import (check_asserts,  # noqa: E402
                                             check_host_reads)
from repro_torch.analysis.census import run_counted  # noqa: E402
from repro_torch.analysis.dispatch_passes import check_program  # noqa: E402
from repro_torch.analysis.ops_passes import check_row  # noqa: E402
from repro_torch.fpp.planner import MemoryModel  # noqa: E402
from repro_torch.kernels import contract  # noqa: E402

ROOT = repo_root()
BUDGETS = ROOT / "src" / "repro_torch" / "analysis" / "budgets.json"
MEM = MemoryModel()


def _mini_repo(tmp_path: pathlib.Path) -> pathlib.Path:
    """A minimal tree the path-scanning passes can run over."""
    for sub in ("core", "fpp", "serve"):
        (tmp_path / "src" / "repro_torch" / sub).mkdir(parents=True)
    (tmp_path / "DESIGN.md").write_text(
        "# design\n\n## §1 Overview\n\nbody\n\n## §2 Engine\n\nbody\n")
    (tmp_path / "README.md").write_text(
        "# readme\n\n## PyTorch/CUDA port\n\nThe engine is "
        "`src/repro_torch/core/`, built into `build/repro_torch/`; run "
        "`python -m repro_torch.core`.\n\n## Next\n\nnothing\n")
    (tmp_path / "src" / "repro_torch" / "core" / "__init__.py").write_text(
        "")
    return tmp_path


def _check(program):
    return check_program(program, "cpu")


def _codes(findings, severity=None):
    return sorted(f.code for f in findings
                  if severity is None or f.severity == severity)


# ------------------------------------------------------------------- ast


def test_bare_assert_caught_and_escape_respected(tmp_path):
    root = _mini_repo(tmp_path)
    (root / "src" / "repro_torch" / "mod.py").write_text(textwrap.dedent("""\
        def f(x):
            assert x > 0
            assert x < 10  # fppcheck: allow-assert
            return x
    """))
    findings = check_asserts(PassContext(root=root))
    assert [f.code for f in findings] == ["bare-assert"]
    assert findings[0].severity == "error"
    assert findings[0].location == "src/repro_torch/mod.py:2"


def test_asserts_exempt_under_tests_dir(tmp_path):
    root = _mini_repo(tmp_path)
    (root / "src" / "repro_torch" / "tests").mkdir()
    (root / "src" / "repro_torch" / "tests" / "t.py").write_text(
        "def f():\n    assert True\n")
    assert check_asserts(PassContext(root=root)) == []


def test_host_read_in_loop_caught(tmp_path):
    root = _mini_repo(tmp_path)
    (root / "src" / "repro_torch" / "core" / "hot.py").write_text(
        textwrap.dedent("""\
            def slow(xs, t):
                out = []
                for x in xs:
                    out.append(x.item())                 # flagged
                    out.append(len(x))                   # no read
                    if bool(t.any()):                    # flagged
                        pass
                    # fppcheck: allow-host-read: one read a round, reported
                    out.append(t.cpu().numpy())
                    out.append(t.tolist())  # fppcheck: allow-host-read
                return out

            def traced(xs):
                for _ in range(3):
                    def body(c):
                        return c.item()                  # nested def: fine
                return body
        """))
    findings = check_host_reads(PassContext(root=root))
    assert _codes(findings) == ["allow-without-reason", "host-read-in-loop",
                                "host-read-in-loop"]
    loc = {f.code: f.location for f in findings
           if f.code == "allow-without-reason"}
    assert loc["allow-without-reason"] == "src/repro_torch/core/hot.py:10"
    hits = sorted(f.location for f in findings
                  if f.code == "host-read-in-loop")
    assert hits == ["src/repro_torch/core/hot.py:4",
                    "src/repro_torch/core/hot.py:6"]
    assert all(f.severity == "error" for f in findings)


def test_host_read_in_loop_caught_under_serve_and_fpp(tmp_path):
    # the serving lanes and the streaming layer are host-side by design; a
    # read a lap there stalls every tenant, so both are policed as core/
    root = _mini_repo(tmp_path)
    for sub in ("serve", "fpp"):
        (root / "src" / "repro_torch" / sub / "lane.py").write_text(
            textwrap.dedent("""\
                def drain(batches, t):
                    while batches:
                        batches.pop()
                        n = int(t.sum())                 # flagged
                    return n
            """))
    findings = check_host_reads(PassContext(root=root))
    assert sorted(f.location for f in findings) == [
        "src/repro_torch/fpp/lane.py:4", "src/repro_torch/serve/lane.py:4"]
    assert "int(.sum())" in findings[0].message


# ------------------------------------------------------------------ docs


def test_dangling_design_ref_caught(tmp_path):
    root = _mini_repo(tmp_path)
    # assembled so the docs pass scanning THIS file doesn't see a citation
    dangling = "DESIGN.md " + chr(0xA7) + "9.3"
    (root / "src" / "repro_torch" / "mod.py").write_text(
        f'"""See {dangling} for details."""\n')
    from repro_torch.analysis.docs import run_pass
    findings = run_pass(PassContext(root=root))
    assert [(f.code, f.location) for f in findings] == [
        ("dangling-ref", "src/repro_torch/mod.py:1")]
    assert "9.3" in findings[0].message and findings[0].severity == "error"


def test_dangling_path_and_module_caught(tmp_path):
    root = _mini_repo(tmp_path)
    from repro_torch.analysis.docs import run_pass
    assert run_pass(PassContext(root=root)) == []   # build/ is generated
    readme = root / "README.md"
    readme.write_text(readme.read_text().replace(
        "`src/repro_torch/core/`", "`src/repro_torch/gone.py`").replace(
        "repro_torch.core`", "repro_torch.gone`"))
    findings = run_pass(PassContext(root=root))
    assert _codes(findings) == ["dangling-module", "dangling-path"]
    assert any("gone.py" in f.message for f in findings)


# --------------------------------------------------------------- kernels


def _contract(**kw):
    c = next(c for c in contract.all_contracts() if c.name == "minplus")
    return dataclasses.replace(c, **kw)


def test_contract_clean_passes():
    assert _codes(kp.check_contract(_contract(), MEM), "error") == []


def test_tile_divisibility_violation_caught():
    t = _contract().out_tiles[0]
    c = _contract(out_tiles=(dataclasses.replace(t, block=(1, 48, 32)),))
    assert _codes(kp.check_contract(c, MEM), "error") == [
        "tile-divisibility"]


def test_grid_coverage_violation_caught():
    c = _contract()
    c = dataclasses.replace(c, grid=(c.grid[0] // 2,) + c.grid[1:])
    assert _codes(kp.check_contract(c, MEM), "error") == ["grid-coverage"]


def test_smem_overflow_caught():
    c = _contract(smem_bytes=MEM.smem_bytes + 16)
    assert "smem-overflow" in _codes(kp.check_contract(c, MEM), "error")


def test_model_overflow_caught_for_wired_kernel():
    # fits a thread block but blows the planner's modeled working set
    c = _contract()
    c = dataclasses.replace(c, smem_bytes=MEM.working_set(
        c.block_size, c.num_queries) + 4)
    assert _codes(kp.check_contract(c, MEM), "error") == ["model-overflow"]


def test_wired_kernel_within_model_reports_footprint():
    findings = kp.check_contract(_contract(), MEM)
    assert [(f.code, f.severity) for f in findings] == [("footprint",
                                                         "info")]


# -------------------------------------------------------------- dispatch


def _program(fn, args, **kw):
    return inv.Program(key="seeded/test", backend="test", kind="test",
                       fn=fn, args=args, **kw)


def test_unreported_host_read_in_loop_caught():
    def fn(x):
        for _ in range(3):
            if not bool((x > 0).any()):   # three reads, none reported
                break
            x = x - 1
        return x

    findings = _check(_program(fn, (torch.full((4,), 5.0),)))
    hits = [f for f in findings if f.code == "host-read-unreported"]
    assert len(hits) == 1 and hits[0].severity == "error"
    assert "3 read(s)" in hits[0].message


def test_reported_read_outside_loop_is_clean():
    def fn(x):
        return x + 1, int(x.sum().item())

    findings = _check(_program(
        fn, (torch.ones(4),), declared_reads=lambda args, out: 1))
    assert findings == []


def test_f64_promotion_caught():
    def fn(x):
        return x.to(torch.float64) * 2.0

    findings = _check(_program(fn, (torch.ones(8),)))
    assert _codes(findings) == ["f64-promotion"]
    assert findings[0].severity == "error"


def test_torch_has_no_weak_output():
    # the reference's weak-output: a literal-only result.  torch gives it
    # the default dtype, strongly typed, so there is nothing to report
    def fn(x):
        return torch.add(torch.tensor(1.0), 2.0)

    out, _ = run_counted(fn, (torch.zeros(4),), "cpu")
    assert out.dtype == torch.float32
    assert _check(_program(fn, (torch.zeros(4),))) == []


@pytest.mark.parametrize("dtype,codes", [
    (torch.float32, ["counter-dtype"]),
    (torch.int64, ["counter-dtype", "int64-state"])])
def test_counter_dtype_contract_enforced(dtype, codes):
    def fn(x):
        return x.sum(dtype=dtype)

    findings = _check(_program(
        fn, (torch.ones(4, dtype=torch.int32),),
        counters=lambda args, out: {"eq": out}))
    assert _codes(findings) == codes


def test_int64_state_caught_and_allowlisted():
    def fn(x, h):
        x += 1
        return x, h

    args = (torch.zeros(4, dtype=torch.int64), torch.zeros(4,
                                                          dtype=torch.int64))
    state = lambda args, out: {"plane": args[0], "hash": args[1]}
    findings = _check(_program(fn, args, state=state,
                                      allow64={"hash": "a uint32 hash"}))
    assert sorted((f.code, f.severity) for f in findings) == [
        ("int64-state", "allowlisted"), ("int64-state", "error")]


@pytest.mark.parametrize("fault", ["slice", "copy", "stride"])
def test_state_not_in_place_caught(fault):
    def fn(x):
        return {"slice": lambda: x[:2], "copy": lambda: x + 0.0,
                "stride": lambda: x.t()}[fault]()

    findings = _check(_program(
        fn, (torch.zeros(4, 4),),
        in_place=lambda args, out: {"state": args[0] if out is None
                                    else out}))
    assert _codes(findings) == ["state-not-in-place"]


def test_host_read_in_fused_chunk_caught():
    def fn(x):
        return x.sum().item(), x.max().item()

    findings = _check(_program(
        fn, (torch.ones(4),), declared_reads=lambda args, out: 2,
        fused=True))
    assert _codes(findings) == ["host-read-in-fused-chunk"]


def test_clean_program_has_no_findings():
    def fn(x, counter):
        x.mul_(0.5)
        counter += 1
        return x, counter

    args = (torch.ones(8), torch.zeros(2, dtype=torch.int32))
    findings = _check(_program(
        fn, args, counters=lambda args, out: {"eq": out[1]},
        in_place=lambda args, out: {"x": args[0], "eq": args[1]}))
    assert findings == []


def test_seeded_tolist_in_a_cpu_program_caught():
    """``.tolist()`` and ``.cpu()`` dispatch nothing on the CPU: the census
    counts them as the card would, and a read of what a read returned is
    the host's."""
    def fn(x):
        host = (x * 2).cpu()
        return host.numpy().sum() + sum(x.tolist()) + int(host[0])

    out, census = run_counted(fn, (torch.ones(4),), "cpu")
    assert census.host_reads == 2
    assert dict(census.reads) == {"Tensor.cpu": 1, "Tensor.tolist": 1}
    findings = _check(_program(fn, (torch.ones(4),)))
    assert _codes(findings) == ["host-read-unreported"]


def test_census_sees_a_wrapper_as_one_launch():
    """The gathered min-plus on the CPU runs its checks (a host read of
    xrow's range) and the plain version; the census sees one launch."""
    from repro_torch.core.engine import column_lists
    from repro_torch.kernels.minplus import ops as mops

    rng = np.random.default_rng(0)
    blocks = np.where(rng.random((3, 16, 16)) < 0.2,
                      rng.random((3, 16, 16)), np.inf).astype(np.float32)
    lists = tuple(torch.from_numpy(a) for a in column_lists(blocks))
    x = torch.from_numpy(rng.random((2, 4, 16)).astype(np.float32))
    idx = torch.tensor([0, 2, 1])
    xrow = torch.tensor([1, 0, 1])
    args = (x, torch.from_numpy(blocks), idx, lists)
    want = mops.minplus(*args, xrow=xrow)
    got, census = run_counted(lambda: mops.minplus(*args, xrow=xrow), (),
                              "cpu")
    assert torch.equal(got, want)
    assert dict(census.launches) == {"minplus": 1}
    assert census.ops_total == 0 and census.host_reads == 0


def test_inactive_launch_hook_is_the_wrapper_itself():
    from repro_torch import kernels
    from repro_torch.kernels.minplus import ops as mops
    from repro_torch.kernels.threefry import ops as tops

    assert kernels._census is None
    key = torch.tensor([0, 7])
    assert torch.equal(tops.draw(key, 5, uniform=True),
                       tops.draw.__wrapped__(key, 5, uniform=True))
    assert mops.minplus.__wrapped__.__name__ == "minplus"


# ------------------------------------------------------------------- ops


_BASE = {"ops_total": 100, "host_reads": 20, "op_copy_": 3}


def test_budget_exceeded_caught():
    row = dict(_BASE, op_copy_=4)      # one extra copy past the ceiling
    findings = check_row("engine/test@cpu", row, _BASE)
    assert [f.code for f in findings] == ["budget-exceeded"]
    assert findings[0].severity == "error"
    assert "op_copy_: 4 > 3" in findings[0].message


def test_budget_is_a_ceiling_not_an_equality():
    row = dict(_BASE, ops_total=90)    # shrinking never fails
    findings = check_row("engine/test@cpu", row, _BASE)
    assert [f.code for f in findings] == ["within-budget"]


def test_unbudgeted_metric_warns():
    row = dict(_BASE, op_cat=1)
    findings = check_row("engine/test@cpu", row, _BASE)
    sev = {f.code: f.severity for f in findings}
    assert sev["unbudgeted-metric"] == "warning"
    assert "budget-exceeded" not in sev


def test_program_with_no_row_fails_and_update_writes_it(tmp_path):
    from repro_torch.analysis.ops_passes import run_pass
    path = tmp_path / "budgets.json"
    ctx = PassContext(budgets_path=path, only_programs="baselines/sssp",
                      device="cpu")
    assert _codes(run_pass(ctx)) == ["no-baseline"]
    ctx.update_budgets = True
    assert _codes(run_pass(ctx)) == ["budgets-updated"]
    assert list(json.loads(path.read_text())) == ["baselines/sssp@cpu"]
    ctx.update_budgets = False
    assert _codes(run_pass(ctx)) == ["within-budget"]


def test_committed_budgets_cover_full_matrix():
    budgets = json.loads(BUDGETS.read_text())
    kinds = ("sssp", "bfs", "ppr", "cc", "kreach", "rw")
    want = {f"{b}/{k}" for b in ("engine", "streaming", "baselines",
                                 "engine-serve") for k in kinds}
    want |= {f"engine-fused/{k}" for k in kinds if k != "rw"}
    cpu = want | {f"distributed/{k}@d{d}" for k in kinds for d in (1, 4)}
    cuda = want | {f"distributed/{k}@d1" for k in kinds}
    assert (len(cpu), len(cuda)) == (41, 35)
    assert set(budgets) == {k + "@cpu" for k in cpu} | {
        k + "@cuda" for k in cuda}
    assert set(inv.all_keys(1)) | set(inv.all_keys(4)) == cpu
    for key, row in budgets.items():
        assert row["ops_total"] > 0, key


# ------------------------------------------------- clean-repo integration


def test_fast_families_clean_on_real_repo():
    """ast + docs + kernels must be green on the committed tree."""
    report = run_passes(["ast.asserts", "ast.host-read", "docs.refs",
                         "kernels.contracts", "kernels.reachability"],
                        PassContext(root=ROOT))
    assert report.ok, report.render()


def test_report_severity_model():
    r = Report(findings=[
        Finding("p", "c", "warning", "loc", "m"),
        Finding("p", "c", "allowlisted", "loc", "m"),
        Finding("p", "c", "info", "loc", "m")], passes_run=["p"])
    assert r.ok                       # only errors fail
    r2 = Report(findings=[Finding("p", "c", "error", "loc", "m")],
                passes_run=["p"])
    assert not r2.ok
    assert r2.as_dict()["counts"]["error"] == 1


# -------------------------------------------------- the inventory itself


@pytest.fixture(scope="module")
def local():
    return {e.key: e for e in inv.evaluate_local("cpu")}


@pytest.fixture(scope="module")
def world():
    return {e.key: e for e in inv.evaluate_world()}


def _clean_and_within_budget(e):
    assert _codes(e.findings, "error") == [], e.findings
    row = json.loads(BUDGETS.read_text())[e.key + "@cpu"]
    assert _codes(check_row(e.key, e.row, row)) == ["within-budget"]


@pytest.mark.parametrize("key", inv.all_keys(1))
def test_inventory_program_clean(local, key):
    """Each program's host reads equal what it reports (one exit test a
    read unfused, one read a fused chunk), no float64, int32 counters,
    state in place, within its committed CPU row."""
    e = local[key]
    _clean_and_within_budget(e)
    launches = sum(v for k, v in e.row.items() if k.startswith("launch_"))
    if key.startswith("engine-fused/"):
        assert (e.row["host_reads"], e.row["launch_fused_visit"],
                launches) == (1, 1, 1)
    elif key.startswith("baselines/"):
        assert (e.row["host_reads"], launches) == (0, 1)
    assert launches > 0


@pytest.mark.parametrize("key", [k for k in inv.all_keys(inv.WORLD)
                                 if k.startswith("distributed/")])
def test_world_program_clean(world, key):
    """The distributed programs on four gloo ranks: clean on every rank,
    within the committed row, the exchange counted."""
    e = world[key]
    _clean_and_within_budget(e)
    assert e.row["collective_calls"] == (0 if key.startswith(
        "distributed/rw") else 3)


def test_canonical_plan_is_the_references():
    from repro_torch.fpp.session import FPPSession
    from repro_torch.graphs.generators import grid2d
    sess = FPPSession(grid2d(16, 16, seed=0), device="cpu").plan(
        num_queries=inv.CANONICAL_Q)
    bg, _ = sess.prepared()
    assert (bg.block_size, bg.num_parts) == (64, 4)


@pytest.mark.parametrize("kind", ["sssp", "ppr", "rw"])
def test_engine_chunk_counters_equal_reference(kind):
    """One chunk's counters (a walk visit's steps) against the reference's
    ``eng._megastep`` (walk visit) on the same input: bitwise for sssp and
    rw; ppr's counters too, its planes within the masked matmul's
    tolerance (ROADMAP C2)."""
    import jax
    import jax.numpy as jnp

    from repro.core.engine import DeviceGraph, FPPEngine
    from repro.core.randomwalk import init_walk_state, make_walk_visit
    from repro.core.yielding import NO_YIELD
    from repro.fpp.backends import _ENGINE_MODE
    from repro.fpp.planner import default_yield_config
    from repro.fpp.session import FPPSession
    from repro.graphs.generators import grid2d

    prog = inv.build_programs(f"engine/{kind}", "cpu")[0]
    out = prog.fn(*prog.args)
    sess = FPPSession(grid2d(16, 16, seed=0))
    sess.plan(num_queries=inv.CANONICAL_Q)
    bg, _ = sess.prepared()
    Q, K = inv.CANONICAL_Q, inv.CANONICAL_K
    if kind == "rw":
        dg = DeviceGraph.build(bg, NO_YIELD, Q)
        st = init_walk_state(dg, np.arange(Q) % bg.n)
        ref = make_walk_visit(dg, inv.CANONICAL_WALK_LEN,
                              inv.CANONICAL_SEED)(*st, jnp.int32(0))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
        assert out[1].dtype == torch.int32
        return
    eng = FPPEngine(bg, mode=_ENGINE_MODE[kind], num_queries=Q,
                    yield_config=default_yield_config(kind, bg), k_visits=K)
    rstate, ms = eng._megastep(eng.init_state(np.arange(Q)), jnp.int32(0),
                               jnp.int32(K), jax.random.PRNGKey(0))
    got = out[1]
    for name in ("eq_hi", "eq_lo", "visit_counts", "order"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ms, name)), name)
    assert got.visits == int(ms.visits) and got.rounds == int(ms.rounds)
    for mine, theirs in zip(out[0].planes, rstate.planes):
        if kind == "ppr":
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       rtol=1e-5, atol=2e-6)
        else:
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("kind", ["sssp", "ppr"])
def test_baseline_rounds_count_edges_in_int32(kind):
    """A round's ``eq`` is int32 (the reference's); a run's int64 total is
    the sum of the rounds' int32 counts."""
    prog = inv.build_programs(f"baselines/{kind}", "cpu")[0]
    out = prog.fn(*prog.args)
    frontier = prog.args[-1]
    assert out[-1].dtype == torch.int32
    deg = torch.from_numpy(np.asarray(
        _sess_bg().deg, dtype=np.int64))[:, None, :]
    want = torch.where(frontier, deg, 0).sum(dim=(0, 2))
    assert torch.equal(out[-1].to(torch.int64), want)


def _sess_bg():
    from repro_torch.fpp.session import FPPSession
    from repro_torch.graphs.generators import grid2d
    sess = FPPSession(grid2d(16, 16, seed=0), device="cpu").plan(
        num_queries=inv.CANONICAL_Q)
    return sess.prepared()[0]


# ------------------------------------------------------------------- CLI


def _cli():
    spec = importlib.util.spec_from_file_location(
        "fppcheck_torch", ROOT / "scripts" / "fppcheck_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_raises_without_a_card_unless_asked_for_cpu(monkeypatch,
                                                         capsys):
    cli = _cli()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        cli.main(["--ops"])
    assert cli.main(["--ast", "--docs"]) == 0     # no device needed
    assert cli.main(["--ops", "--device", "cpu",
                     "--only", "baselines/bfs"]) == 0
    assert "fppcheck: OK" in capsys.readouterr().out
