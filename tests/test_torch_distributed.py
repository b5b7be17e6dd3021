"""The distributed backend of the port (``core/distributed``,
``launch/mesh``, ``models/attention.decode_attend_partitioned``) against the
JAX package's pod runtime, on the CPU.

* ``ShardedGraph.build`` is the reference's field for field.
* One 4-rank gloo world of the port (``launch/mesh.spawn``, one thread a
  rank) and two reference processes with four XLA host devices each (side
  by side) run the same cases: a grid and a directed R-MAT at B = 32 and Q = 4, meshes (1, 4) and
  (2, 2), all six kinds, through ``FPPSession.run(...,
  backend="distributed", mesh=...)``; the grid at mesh (4, 1) and an
  Erdős–Rényi graph whose 10 partitions (B = 16) the model axis of 4 does
  not divide, all six kinds; and the partitioned decode at meshes (1, 4)
  and (2, 2), with and without a window.
* sssp, bfs, cc and kreach are bitwise (values, hops, supersteps, edges);
  rw's occupancy and steps are bitwise; ppr is held within 4·eps,
  deg-normalised, and keeps the residual bound and mass conservation (its
  float sums may round apart from XLA's, so its supersteps and edges are
  not held: ROADMAP C2); the decode is held within 1e-5, the reference
  test's bound.  Every rank returns the same bits.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import distributed as jdist  # noqa: E402
from repro.core.partition import partition as jpartition  # noqa: E402
from repro.core.yielding import YieldConfig as JYieldConfig  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import distributed as dist_rt  # noqa: E402
from repro_torch.core.partition import partition  # noqa: E402
from repro_torch.core.yielding import YieldConfig  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.launch import distributed as launcher  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAPHS = {
    "grid": ("grid2d", {"rows": 16, "cols": 16, "seed": 3}),
    "rmat": ("rmat", {"scale": 7, "edge_factor": 4, "seed": 5,
                      "symmetrize": False}),
}
MESHES = [(1, 4), (2, 2)]
KINDS = ["sssp", "bfs", "ppr", "cc", "kreach", "rw"]
SRCS = [0, 30, 100, 77]
BLOCK, Q, EPS = 32, 4, 1e-4
#: the cases the loops above leave out: the query axis alone (4, 1), and
#: partitions that do not split evenly over the model axis (P = 10 at
#: B = 16 over 4 ranks); (graph, block size, mesh)
ODD_GRAPHS = {"er": ("erdos_renyi", {"n": 150, "avg_deg": 2.0, "seed": 4})}
ODD = [("grid", BLOCK, (4, 1)), ("er", 16, (1, 4))]
DECODE_SHAPE = (4, 32, 4, 2, 16)         # B, S, H, Hkv, hd
DECODE_LENGTHS = [5, 17, 32, 9]
WINDOWS = [None, 8]
WORLD_TIMEOUT_S = 60


def _graph(pkg, name):
    fn, kw = {**GRAPHS, **ODD_GRAPHS}[name]
    return getattr(pkg, fn)(**kw)


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_sharded_graph_matches_reference(name, ndev):
    jbg, _ = jpartition(_graph(jgen, name), BLOCK)
    bg, _ = partition(_graph(gen, name), BLOCK)
    want = jdist.ShardedGraph.build(jbg, ndev, JYieldConfig(), Q)
    got = dist_rt.ShardedGraph.build(bg, ndev, YieldConfig(), Q)
    for f, w in dataclasses.asdict(want).items():
        g = getattr(got, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


# ---------------------------------------------------------------------------
# one reference process and one port world for every case below


_REF_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from repro.fpp import FPPSession
    from repro.graphs import generators
    from repro.launch.mesh import set_mesh
    from repro.models import attention as A

    spec = json.loads(sys.argv[1])
    arrays = np.load(sys.argv[2])
    part = sys.argv[4]            # "main" or "odd": run side by side
    srcs = np.asarray(spec["srcs"])
    out = {}
    for gname, (fn, kw) in spec["graphs"].items() if part == "main" else ():
        sess = FPPSession(getattr(generators, fn)(**kw)).plan(
            num_queries=spec["q"], block_size=spec["block"])
        for shape in map(tuple, spec["meshes"]):
            mesh = jax.make_mesh(shape, ("data", "model"))
            for kind in spec["kinds"]:
                r = sess.run(kind, srcs, backend="distributed", mesh=mesh,
                             eps=spec["eps"])
                key = f"{gname}_{shape[0]}x{shape[1]}_{kind}"
                out[key + "_values"] = r.values
                out[key + "_edges"] = r.edges_processed
                out[key + "_supersteps"] = r.stats["supersteps"]
                if r.residual is not None:
                    out[key + "_residual"] = r.residual
    for gname, block, shape in spec["odd"] if part == "odd" else ():
        fn, kw = spec["all_graphs"][gname]
        sess = FPPSession(getattr(generators, fn)(**kw)).plan(
            num_queries=spec["q"], block_size=block)
        mesh = jax.make_mesh(tuple(shape), ("data", "model"))
        for kind in spec["kinds"]:
            r = sess.run(kind, srcs, backend="distributed", mesh=mesh,
                         eps=spec["eps"])
            key = f"{gname}_{shape[0]}x{shape[1]}_{kind}"
            out[key + "_values"] = r.values
            out[key + "_edges"] = r.edges_processed
            out[key + "_supersteps"] = r.stats["supersteps"]
            if r.residual is not None:
                out[key + "_residual"] = r.residual
    q, k, v = (jnp.asarray(arrays[n]) for n in ("q", "k", "v"))
    length = jnp.asarray(spec["lengths"], jnp.int32)
    S = k.shape[1]
    for w in spec["windows"] if part == "main" else ():
        out[f"decode_local_{w}"] = np.asarray(A.decode_attend_local(
            q, k, v, jnp.arange(S), length, window=w))
        for shape in map(tuple, spec["meshes"]):
            mesh = jax.make_mesh(shape, ("data", "model"))
            with set_mesh(mesh):
                got = A.decode_attend_partitioned(
                    q, k, v, length, mesh, window=w, batch_axes=("data",))
            out[f"decode_{shape[0]}x{shape[1]}_{w}"] = np.asarray(got)
    np.savez(sys.argv[3], **out)
    print("REF_OK")
""")


def _port_cases():
    cases = [{"graph": GRAPHS[g], "mesh": m, "kind": kind, "sources": SRCS,
              "num_queries": Q, "block_size": BLOCK, "eps": EPS}
             for g in GRAPHS for m in MESHES for kind in KINDS]
    cases += [{"graph": {**GRAPHS, **ODD_GRAPHS}[g], "mesh": m, "kind": kind,
               "sources": SRCS, "num_queries": Q, "block_size": block,
               "eps": EPS}
              for g, block, m in ODD for kind in KINDS]
    cases += [{"decode": True, "mesh": m, "shape": DECODE_SHAPE, "seed": 1,
               "dtype": "float32", "lengths": DECODE_LENGTHS, "window": w}
              for w in WINDOWS for m in MESHES]
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference npz, the port's per-rank results by case key): the
    reference's two processes run while the port's world does."""
    tmp = tmp_path_factory.mktemp("distributed")
    q, k, v = launcher.decode_inputs(DECODE_SHAPE, 1, "float32")
    np.savez(tmp / "decode.npz", q=q.numpy(), k=k.numpy(), v=v.numpy())
    spec = json.dumps({"graphs": GRAPHS, "meshes": MESHES, "kinds": KINDS,
                       "srcs": SRCS, "q": Q, "block": BLOCK, "eps": EPS,
                       "lengths": DECODE_LENGTHS, "windows": WINDOWS,
                       "odd": ODD, "all_graphs": {**GRAPHS, **ODD_GRAPHS}})
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    refs = [subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, spec, str(tmp / "decode.npz"),
         str(tmp / f"ref_{part}.npz"), part], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ("main", "odd")]
    try:
        cases = _port_cases()
        per_rank = tmesh.spawn(launcher.run_cases, 4, "gloo",
                               args=(cases, "cpu"),
                               timeout_s=WORLD_TIMEOUT_S)
        for ref in refs:
            out, err = ref.communicate(timeout=300)
            assert ref.returncode == 0 and "REF_OK" in out, err[-3000:]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    keys = []
    for c in cases:
        m = f"{c['mesh'][0]}x{c['mesh'][1]}"
        if c.get("decode"):
            keys.append(f"decode_{m}_{c['window']}")
        else:
            g = next(n for n, spec in {**GRAPHS, **ODD_GRAPHS}.items()
                     if spec == c["graph"])
            keys.append(f"{g}_{m}_{c['kind']}")
    port = {key: [rank[i] for rank in per_rank] for i, key in enumerate(keys)}
    want = {}
    for part in ("main", "odd"):
        want.update(np.load(tmp / f"ref_{part}.npz"))
    return want, port


def _same_across_ranks(results):
    assert launcher.same_answers([[r] for r in results])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", list(GRAPHS))
def test_four_rank_world_matches_reference(runs, name, mesh, kind):
    _check_case(runs, name, mesh, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,block,mesh", ODD,
                         ids=[f"{g}-B{b}-{m[0]}x{m[1]}" for g, b, m in ODD])
def test_query_axis_and_uneven_partitions_match_reference(runs, name, block,
                                                         mesh, kind):
    """Mesh (4, 1) (the queries split four ways, one partition owner) and
    P = 10 partitions over a model axis of 4, as the reference."""
    _check_case(runs, name, mesh, kind)


def _check_case(runs, name, mesh, kind):
    ref, port = runs
    key = f"{name}_{mesh[0]}x{mesh[1]}_{kind}"
    results = port[key]
    _same_across_ranks(results)
    got = results[0]
    want_v = ref[key + "_values"]
    assert got["values"].dtype == np.float32
    if kind != "ppr":
        np.testing.assert_array_equal(got["values"], want_v)
        np.testing.assert_array_equal(got["edges"], ref[key + "_edges"])
        assert got["stats"]["supersteps"] == int(ref[key + "_supersteps"])
        if kind == "kreach":
            np.testing.assert_array_equal(got["residual"],
                                          ref[key + "_residual"])
        return
    deg = _graph(gen, name).out_degree()
    err = np.abs(got["values"] - want_v) / np.maximum(deg, 1)
    assert err.max() <= 4 * EPS, err.max()
    r = got["residual"]
    mass = got["values"].sum(1) + r.sum(1)
    assert np.abs(mass - 1.0).max() < 5e-3, mass
    assert (r[:, deg > 0] <= EPS * deg[deg > 0] + 1e-6).all()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_partitioned_decode_matches_reference(runs, mesh, window):
    ref, port = runs
    results = port[f"decode_{mesh[0]}x{mesh[1]}_{window}"]
    _same_across_ranks(results)
    got = results[0]["out"]
    for want in (ref[f"decode_local_{window}"],
                 ref[f"decode_{mesh[0]}x{mesh[1]}_{window}"]):
        assert np.abs(got - want).max() < 1e-5


# ---------------------------------------------------------------------------
# guards and meshes


def test_query_sharding_raises_the_reference_error():
    bg, perm = partition(_graph(gen, "grid"), BLOCK)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    with pytest.raises(ValueError) as want:
        jdist._check_query_sharding(3, mesh, ("data",))
    with pytest.raises(ValueError) as got:
        dist_rt.run_distributed_sssp(bg, perm[SRCS[:3]], mesh, device="cpu")
    assert str(got.value) == str(want.value)


def test_host_mesh_falls_back_past_the_world_as_the_reference():
    """The reference's rule: ``(1, 1)`` when ``data * model`` exceeds the
    devices (here: a world of one, no process group)."""
    assert tmesh.world_size() == 1
    for shape in ((2, 2), (1, 2), (4, 1), (1, 1)):
        got = tmesh.make_host_mesh(*shape)
        assert got.shape == {"data": 1, "model": 1}
        assert tmesh.chips(got) == 1
        assert got.coords == {"data": 0, "model": 0}
    one = tmesh.make_host_mesh()
    x = torch.arange(6.0).reshape(1, 2, 3)
    assert one.all_to_all(x, "model") is x
    assert one.all_reduce_max(x) is x and one.all_reduce_sum(x) is x
    assert one.all_gather(x, "data").shape == (1, 1, 2, 3)


@pytest.mark.parametrize("multi_pod,size", [(False, 256), (True, 512)])
def test_production_mesh_needs_its_world(multi_pod, size):
    with pytest.raises(ValueError, match=f"{size} ranks; this one has 1"):
        tmesh.make_production_mesh(multi_pod=multi_pod)
