"""Training on a mesh (``Model.loss(rules=)``, ``make_train_step(rules=)``,
``state_shardings``, ``compressed_psum``, the sharded checkpoint and
``launch/elastic.reshard_restore``) against the JAX package, on the CPU.

* Without a world: ``state_shardings`` and ``batch_shardings`` against
  the reference's ``PartitionSpec`` trees for every registered config at
  meshes (1, 4), (2, 2), (4, 1) and (16, 16) (rules from axis sizes
  alone).
* One 4-rank gloo world of the port (``launch/mesh.spawn`` of
  ``launch/distributed.run_train_cases``) and one reference process with
  four XLA host devices, side by side, from the reference's
  ``init_train_state(PRNGKey(0))`` carried across as numpy arrays, in
  float32 compute, batches of 8 x 16 in 2 microbatches:

  - the first batch's gradients: each rank's shard against its block of
    the reference's ``jax.value_and_grad`` of ``Model.loss`` averaged over
    the microbatches, within ``GRAD_REL`` of the leaf's largest entry, for
    reduced starcoder2-7b in the attention layouts of ``manual_tp``
    (``replicated``: 4 / 1 heads; ``heads``: 8 / 4; ``full``: 6 / 2 heads,
    with an MLP of 126 that a model axis of 4 does not split) at (1, 4),
    (2, 2) and (4, 1), and reduced paligemma-3b and whisper-base at
    (2, 2);
  - two steps of ``make_train_step(rules=)``: the metrics, and each
    rank's shards of the params and moments, against the reference's plain
    jitted step (and its sharded step at (2, 2)) at
    ``tests/test_torch_train.py``'s tolerances; every rank the same loss
    and grad-norm bits, and replicas of a leaf equal bit for bit;
  - ``compression=True`` at (2, 2): the error-feedback residual too;
  - a checkpoint written by the (2, 2) world restores bit for bit through
    the reference's ``train/checkpoint.restore``;
  - ``reshard_restore`` (2, 2) -> (4, 1) -> one device, 2 steps each,
    against the reference's uninterrupted 6 steps;
  - ``compressed_psum`` over ``"model"`` of (1, 4) and ``"data"`` of
    (2, 2) bit for bit against the reference's ``shard_map``, and within
    ``PSUM_REL`` of the float sum;
  - ``launch/train.run(mesh=)`` at (2, 2) stopped after its step-2
    checkpoint and run again resumes bit for bit as the uninterrupted
    run;
  - ``"act_seq"`` (the reference's layer-boundary carry split over
    ``"model"`` on its sequence) against the same runs with it off
    (``rules_for(..., overrides={"act_seq": None})``), gradients, metrics
    and two steps bit for bit on every rank, for reduced starcoder2-7b and
    paligemma-3b (its image prefix in the sequence), qwen3-moe and
    recurrentgemma (a group and a tail layer) at (1, 4) and (2, 2), and
    starcoder2 at a sequence of 18 (whole: 4 does not divide it), with
    each forward's carries read from ``launch/distributed.LayoutLog``.
"""
import dataclasses
import functools
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

from repro.configs.base import get_config as jget  # noqa: E402
from repro.configs.base import list_configs as jlist  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.launch import distributed as launcher  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.models.sharding import shard_by_spec  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.train.checkpoint import _flatten  # noqa: E402
from repro_torch.train.optimizer import AdamState, AdamW  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
AXES = ("data", "model")
SPEC_MESHES = [(1, 4), (2, 2), (4, 1), (16, 16)]
MESHES = [(1, 4), (2, 2), (4, 1)]
#: reduced configs: (arch, fields replaced after ``reduced()``).  At a
#: model axis of 4 and 2: 4 / 1 heads of 16 read one kv head projected
#: whole (``replicated``); 8 / 4 split the kv heads (``heads``); 6 / 2
#: heads do not divide 4 (``full``: the block computed whole on every rank)
#: and d_ff 126 does not either (the MLP computed whole)
CONFIGS = {
    "starcoder2": ("starcoder2-7b", {}),
    "starcoder2-kv4": ("starcoder2-7b", {"n_heads": 8, "n_kv_heads": 4}),
    "starcoder2-h6": ("starcoder2-7b", {"n_heads": 6, "n_kv_heads": 2,
                                        "d_ff": 126}),
    "paligemma": ("paligemma-3b", {}),
    "whisper": ("whisper-base", {}),
}
LAYOUTS = ["starcoder2", "starcoder2-kv4", "starcoder2-h6"]
#: (config key, mesh) of the gradient and two-step cases
CASES = [(k, m) for k in LAYOUTS for m in MESHES] + [
    ("paligemma", (2, 2)), ("whisper", (2, 2))]
SHARDED_REF = ("starcoder2", (2, 2))     # also against the reference's
COMPRESS = ("starcoder2", (2, 2))        # sharded step; with compression
ELASTIC_KEY = "starcoder2"
ELASTIC_LEGS = [((2, 2), 2), ((4, 1), 2), (None, 2)]
SEQ, BATCH, MICRO, STEPS = 16, 8, 2, 2
LR = ("warmup_cosine", (1e-2, 1, 4))
#: a gradient shard against its block of the reference's: within this
#: share of the leaf's largest entry
GRAD_REL = 1e-5
#: test_torch_train.py's step tolerances.  A parameter may move beyond
#: TOL by what AdamW makes of its moments' differences (themselves within
#: TOL): where a gradient sums to almost nothing, ``m / (sqrt(v) + eps)``
#: turns a rounding of the sum into a visible step.  So a parameter is
#: held within TOL plus the update's first-order change under the moments'
#: differences, ``lr * (|dm| / (s + eps) + |m| ds / (s + eps)^2)`` with
#: ``s = sqrt(v)`` (both bias-corrected), summed over the steps' rates
TOL = dict(rtol=1e-5, atol=1e-5)
NU_TOL = dict(rtol=1e-5, atol=1e-9)
#: compressed_psum against the float sum, relative to its largest entry
#: (int8 rounding: half a step of max|x| / 127 a rank, 4 ranks)
PSUM_REL = 0.02
PSUM_CASES = [((1, 4), "model"), ((2, 2), "data")]
WORLD_TIMEOUT_S = 120
#: ``"act_seq"`` (the layer-boundary carry split over ``"model"`` on its
#: sequence) against the same run under ``rules_for(..., overrides=
#: ACT_SEQ_OFF)``, bit for bit: the CASES paired with a run of their own
#: with it off, and on/off pairs from the port's seeded state (reduced
#: qwen3-moe and recurrentgemma, one group and a tail layer, at SEQ; the
#: dense config at 18, which a model axis of 4 does not divide)
ACT_SEQ_OFF = {"act_seq": None}
ACT_SEQ_CASES = [("starcoder2", (1, 4)), ("starcoder2", (2, 2)),
                 ("paligemma", (2, 2))]
ACT_SEQ_CONFIGS = {"qwen3-moe": ("qwen3-moe-30b-a3b", SEQ),
                   "recurrentgemma": ("recurrentgemma-2b", SEQ),
                   "starcoder2-s18": ("starcoder2-7b", 18)}
ACT_SEQ_PAIRS = [(k, m) for k in ("qwen3-moe", "recurrentgemma")
                 for m in [(1, 4), (2, 2)]] + [("starcoder2-s18", (1, 4))]
ACT_SEQ_ALL = ACT_SEQ_CASES + ACT_SEQ_PAIRS


def _mname(m):
    return "1dev" if m is None else f"{m[0]}x{m[1]}"


class _RankOf:
    """Where rank ``rank`` of a ``(data, model)`` mesh sits, without a
    world: what ``shard_by_spec`` reads of a ``launch/mesh.Mesh``."""
    index = tmesh.Mesh.index

    def __init__(self, shape, rank):
        self.axis_names = AXES
        self.shape = dict(zip(AXES, shape))
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(
            rank, shape))))


def _fake_jax_mesh(shape):
    return types.SimpleNamespace(axis_names=AXES,
                                 devices=np.empty(shape, dtype=object))


# ---------------------------------------------------------------------------
# without a world


def _ref_specs(tree):
    """``{path: spec tuple}`` of the reference's state_shardings tree
    (``NamedSharding`` replaced by its spec)."""
    return {k: tuple(v) for k, v in _flatten(tree, specs=True).items()}


@pytest.mark.parametrize("mesh", SPEC_MESHES, ids=_mname)
@pytest.mark.parametrize("name", jlist())
def test_state_and_batch_shardings_match_reference(name, mesh, monkeypatch):
    """``state_shardings`` (params, moments, master, ef; count and step
    replicated) and ``batch_shardings`` equal the reference's
    ``PartitionSpec`` trees, from the axis sizes alone."""
    import jax.sharding as jsh
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    jmodel = jbuild(jget(name))
    pspecs, axes = jsteps.abstract_params(jmodel)
    f32s = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, np.float32),
                        pspecs)
    jstate = jts.TrainState(
        params=pspecs, opt=jopt.AdamState(mu=f32s, nu=f32s, count=None,
                                          master=f32s),
        step=None, ef=f32s)
    jrules = jsteps.rules_for(jget(name), _fake_jax_mesh(mesh))
    want = _ref_specs(jts.state_shardings(jstate, axes, jrules))
    tmodel = tbuild(tget(name))
    shapes = tmodel.param_shapes()
    tstate = tts.TrainState(params=shapes, opt=AdamState(
        mu=shapes, nu=shapes, count=None, master=shapes), step=None,
        ef=shapes)
    trules = tsteps.rules_for(tget(name), dict(zip(AXES, mesh)))
    got = tts.state_shardings(tstate, tmodel.param_axes(), trules)
    assert {k: tuple(v) for k, v in _flatten(got, specs=True).items()} \
        == want
    batch = {"tokens": (4, 32), "labels": (4, 32), "loss_mask": (4, 32),
             "frames": (4, 32, 8)}
    jb = jts.batch_shardings({k: jax.ShapeDtypeStruct(v, np.float32)
                              for k, v in batch.items()}, jrules)
    tb = tts.batch_shardings({k: torch.empty(v) for k, v in batch.items()},
                             trules)
    assert tb == {k: tuple(v) for k, v in jb.items()}


# ---------------------------------------------------------------------------
# one reference process and one port world


def _configs(key):
    arch, fields = CONFIGS[key]
    jcfg = dataclasses.replace(jget(arch).reduced(),
                               compute_dtype="float32", **fields)
    tcfg = dataclasses.replace(tget(arch).reduced(),
                               compute_dtype="float32", **fields)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _init_state(key, compression):
    """The reference's initial train state as numpy (``PRNGKey(0)``)."""
    jcfg, _ = _configs(key)
    js = jts.init_train_state(jbuild(jcfg), jax.random.PRNGKey(0),
                              jopt.AdamW(), compression=compression)
    arr = lambda t: None if t is None else jax.tree.map(np.asarray, t)  # noqa
    return {"params": arr(js.params), "mu": arr(js.opt.mu),
            "nu": arr(js.opt.nu), "count": arr(js.opt.count),
            "master": arr(js.opt.master), "ef": arr(js.ef),
            "step": arr(js.step)}


def _port_case(key, mesh, steps=STEPS, **extra):
    arch, fields = CONFIGS[key]
    return {"arch": arch, "reduced": True,
            "config": {"compute_dtype": "float32", **fields}, "mesh": mesh,
            "state": _init_state(key, extra.get("compression", False)),
            "seq": SEQ, "batch": BATCH, "microbatches": MICRO, "lr": LR,
            "steps": steps, **extra}


def _psum_inputs():
    return np.random.default_rng(5).normal(size=(4, 6, 10)).astype(
        np.float32)


def _ref_inputs(tmp):
    """Every config's initial state, saved for the reference process."""
    paths = {}
    for key in CONFIGS:
        for comp in (False, True):
            st = _init_state(key, comp)
            flat = {k: v for k, v in _flatten(st).items()}
            path = tmp / f"state_{key}_{int(comp)}.npz"
            np.savez(path, **flat)
            paths[f"{key}_{int(comp)}"] = str(path)
    return paths


_REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.configs.base import get_config
    from repro.configs.shapes import ShapeConfig
    from repro.launch.mesh import compat_make_mesh, set_mesh
    from repro.launch.steps import rules_for
    from repro.models.factory import build_model
    from repro.models.sharding import shard_map_compat
    from repro.train import compress, optimizer as opt
    from repro.train.data import batch_for_step
    from repro.train.optimizer import AdamState
    from repro.train.train_step import TrainState, make_train_step

    spec = json.loads(open(sys.argv[1]).read())
    out = {}

    def config(key):
        arch, fields = spec["configs"][key]
        return dataclasses.replace(get_config(arch).reduced(),
                                   compute_dtype="float32", **fields)

    def unflat(flat, prefix):
        tree = {}
        for k, v in flat.items():
            if not k.startswith(prefix):
                continue
            node = tree
            *head, last = k[len(prefix):].split("::")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = jnp.asarray(v)
        return tree

    def state(key, comp):
        flat = dict(np.load(spec["states"][f"{key}_{int(comp)}"]))
        get = lambda p: unflat(flat, p) or None
        return TrainState(
            params=get("params::"),
            opt=AdamState(mu=get("mu::"), nu=get("nu::"),
                          count=jnp.asarray(flat["count"]), master=None),
            step=jnp.asarray(flat["step"]), ef=get("ef::"))

    def put(prefix, tree):
        for k, v in jax.tree_util.tree_leaves_with_path(tree):
            out[prefix + "/".join(str(p.key) for p in k)] = np.asarray(v)

    shape = ShapeConfig("t", "train", spec["seq"], spec["batch"])
    lr = getattr(opt, spec["lr"][0])(*spec["lr"][1])
    mb = spec["micro"]

    def steps(key, n, rules=None, mesh=None, comp=False, tag=""):
        cfg = config(key)
        model = build_model(cfg)
        st = state(key, comp)
        fn = jax.jit(make_train_step(model, opt.AdamW(), lr, rules=rules,
                                     microbatches=mb, compression=comp))
        losses = []
        for s in range(n):
            b = batch_for_step(cfg, shape, s)
            if mesh is None:
                st, m = fn(st, b)
            else:
                with set_mesh(mesh):
                    st, m = fn(st, b)
            losses.append([float(m["loss"]), float(m["grad_norm"])])
            if s + 1 in spec["keep"]:
                pre = f"{tag}{key}_{s + 1}_"
                put(pre + "params/", st.params)
                put(pre + "mu/", st.opt.mu)
                put(pre + "nu/", st.opt.nu)
                if comp:
                    put(pre + "ef/", st.ef)
        out[f"{tag}{key}_metrics"] = np.asarray(losses)

    for key in spec["configs"]:
        cfg = config(key)
        model = build_model(cfg)
        st = state(key, False)
        b = batch_for_step(cfg, shape, 0)
        per = spec["batch"] // mb
        g = None
        grad = jax.jit(jax.grad(lambda p, x: model.loss(p, x)[0]))
        for i in range(mb):
            mbatch = {k: v[i * per:(i + 1) * per] for k, v in b.items()}
            gi = grad(st.params, mbatch)
            g = gi if g is None else jax.tree.map(jnp.add, g, gi)
        put(f"grads_{key}/", jax.tree.map(lambda x: x / mb, g))
        steps(key, spec["elastic_steps"] if key == spec["elastic"]
              else spec["steps"])
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    key = spec["sharded"]
    steps(key, spec["steps"], rules_for(config(key), mesh), mesh,
          tag="sharded_")
    steps(spec["compress"], spec["steps"], comp=True, tag="compress_")

    x = np.asarray(spec["psum_x"], np.float32)
    for shape_, axis in spec["psum"]:
        m = compat_make_mesh(tuple(shape_), ("data", "model"))
        f = shard_map_compat(lambda v: compress.compressed_psum(v, axis),
                             mesh=m, in_specs=P(("data", "model")),
                             out_specs=P(("data", "model")))
        out[f"psum_{shape_[0]}x{shape_[1]}_{axis}"] = np.asarray(
            jax.jit(f)(jnp.asarray(x)))
    np.savez(sys.argv[2], **out)
    print("REF_OK")
""")


def _launch_cases(tmp):
    """``launch/train.run`` on (2, 2): 4 steps uninterrupted, then 2 steps
    and a rerun to 4 from the same checkpoint directory."""
    def case(steps, d):
        return {"arch": "starcoder2-7b", "mesh": (2, 2), "config": {
            "compute_dtype": "float32"}, "argv": [
            "--reduced", "--device", "cpu", "--steps", str(steps),
            "--batch", "4", "--seq", "16", "--microbatches", "2",
            "--lr", "3e-3", "--ckpt-every", "2", "--ckpt-dir", str(d)]}
    return [case(4, tmp / "run_a"), case(2, tmp / "run_b"),
            case(4, tmp / "run_b")]


@functools.lru_cache(maxsize=None)
def _seeded_state(arch):
    """The port's seeded initial train state (generator 1) of a reduced
    float32 config, as numpy."""
    cfg = dataclasses.replace(tget(arch).reduced(), compute_dtype="float32")
    st = tts.init_train_state(tbuild(cfg), torch.Generator().manual_seed(1),
                              AdamW(), device="cpu")
    arrays = lambda tree: {k: arrays(v) if isinstance(v, dict)  # noqa
                           else v.numpy().copy() for k, v in tree.items()}
    return {"params": arrays(st.params), "mu": arrays(st.opt.mu),
            "nu": arrays(st.opt.nu), "count": st.opt.count.numpy(),
            "step": st.step.numpy()}


def _act_seq_cases():
    """The ``"act_seq"`` cases, in :func:`_act_seq_index`'s order: an off
    run of each of ACT_SEQ_CASES, then an on and an off run of each of
    ACT_SEQ_PAIRS."""
    cases = [_port_case(k, m, grads=True, overrides=ACT_SEQ_OFF)
             for k, m in ACT_SEQ_CASES]
    for key, mesh in ACT_SEQ_PAIRS:
        arch, seq = ACT_SEQ_CONFIGS[key]
        case = {"arch": arch, "reduced": True,
                "config": {"compute_dtype": "float32"}, "mesh": mesh,
                "state": _seeded_state(arch), "seq": seq, "batch": BATCH,
                "microbatches": MICRO, "lr": LR, "steps": STEPS,
                "grads": True}
        cases += [case, {**case, "overrides": ACT_SEQ_OFF}]
    return cases


def _world_cases(ckpt_dir):
    cases = [_port_case(k, m, grads=True) for k, m in CASES]
    cases.append(_port_case(*COMPRESS, compression=True))
    (m0, n0), *rest = ELASTIC_LEGS
    cases.append(_port_case(ELASTIC_KEY, m0, n0, ckpt_dir=str(ckpt_dir),
                            reshard=rest))
    x = _psum_inputs()
    cases += [{"psum": {"mesh": m, "axis": a, "x": x}} for m, a in
              PSUM_CASES]
    return cases + _launch_cases(ckpt_dir.parent) + _act_seq_cases()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference npz, the port's per-rank results by case, the elastic
    case's checkpoint directory): the reference process runs while the
    port's world does."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    spec = {"configs": CONFIGS, "states": _ref_inputs(tmp), "seq": SEQ,
            "batch": BATCH, "micro": MICRO, "lr": LR, "steps": STEPS,
            "keep": [STEPS, sum(n for _, n in ELASTIC_LEGS)],
            "elastic": ELASTIC_KEY,
            "elastic_steps": sum(n for _, n in ELASTIC_LEGS),
            "sharded": SHARDED_REF[0], "compress": COMPRESS[0],
            "psum": PSUM_CASES, "psum_x": _psum_inputs().tolist()}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp / "spec.json"),
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ckpt = tmp / "ckpt"
    try:
        cases = _world_cases(ckpt)
        per_rank = tmesh.spawn(launcher.run_train_cases, 4, "gloo",
                               args=(cases, "cpu"),
                               timeout_s=WORLD_TIMEOUT_S)
        out, err = ref.communicate(timeout=900)
        assert ref.returncode == 0 and "REF_OK" in out, err[-3000:]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    return dict(np.load(tmp / "ref.npz")), per_rank, ckpt


def _ref_tree(ref, prefix):
    return {k[len(prefix):].replace("/", "::"): v for k, v in ref.items()
            if k.startswith(prefix)}


def _specs(key, mesh):
    """``{params leaf path: spec}`` of a config at a mesh."""
    _, tcfg = _configs(key)
    model = tbuild(tcfg)
    rules = tsteps.rules_for(tcfg, dict(zip(AXES, mesh)))
    specs = tts.state_shardings(tts.TrainState(
        params=model.param_shapes(), opt=AdamState(None, None, None),
        step=None), model.param_axes(), rules)
    return {k: v for k, v in _flatten(specs.params, specs=True).items()}


def _block(whole, spec, mesh, rank):
    return shard_by_spec(torch.from_numpy(np.asarray(whole)), spec,
                         _RankOf(mesh, rank)).numpy()


def _case_index(key, mesh):
    return CASES.index((key, mesh))


def _shards_close(per_rank, idx, want, specs, mesh, grad_rel):
    """Every rank's gradient shards against their blocks of the whole
    ``want`` leaves, within ``grad_rel`` of each leaf's largest entry."""
    for rank, res in enumerate(per_rank):
        got = res[idx]["grads"]
        assert sorted(got) == sorted(want)
        for path, whole in want.items():
            block = _block(whole, specs[path], mesh, rank)
            bound = grad_rel * float(np.abs(whole).max())
            err = float(np.abs(got[path] - block).max())
            assert err <= bound, (rank, path, err, bound)


def _lr_sum(n):
    lr = getattr(topt, LR[0])(*LR[1])
    return sum(float(lr(s)) for s in range(n))


def _state_close(got, ref, tag, specs, mesh, rank, n, parts=("mu", "nu")):
    """One rank's state (``{checkpoint path: numpy}``) after ``n`` steps
    against its blocks of the reference's ``tag`` state: the moments (and
    ``parts`` beyond them) within TOL, the params within TOL plus AdamW's
    slack (see TOL)."""
    def blocks(part):
        want = _ref_tree(ref, f"{tag}_{part}/")
        return {p: (w if mesh is None else _block(w, specs[p], mesh, rank))
                for p, w in want.items()}
    pre = {"params": ".params::", "mu": ".opt::.mu::", "nu": ".opt::.nu::",
           "ef": ".ef::"}
    w = {part: blocks(part) for part in ("params",) + tuple(parts)}
    for part in parts:
        for path, want in w[part].items():
            np.testing.assert_allclose(
                got[pre[part] + path], want,
                **(NU_TOL if part == "nu" else TOL),
                err_msg=f"{tag} {part} {path} rank {rank}")
    opt = AdamW()
    bc1, bc2 = 1 - opt.b1 ** n, 1 - opt.b2 ** n
    lr = _lr_sum(n)
    for path, want in w["params"].items():
        m, v = w["mu"][path] / bc1, w["nu"][path] / bc2
        dm = np.abs(got[pre["mu"] + path] / bc1 - m)
        s = np.sqrt(v)
        ds = np.abs(np.sqrt(got[pre["nu"] + path] / bc2) - s)
        slack = lr * (dm / (s + opt.eps) + np.abs(m) * ds
                      / (s + opt.eps) ** 2)
        bound = TOL["atol"] + TOL["rtol"] * np.abs(want) + slack
        d = np.abs(got[pre["params"] + path] - want)
        assert (d <= bound).all(), (tag, path, rank, float(d.max()))


@pytest.mark.parametrize("key,mesh", CASES,
                         ids=[f"{k}-{_mname(m)}" for k, m in CASES])
def test_gradient_shards_match_reference(runs, key, mesh):
    """Each rank's shard of the first batch's gradients (2 microbatches)
    against its block of ``jax.grad`` of the reference's ``Model.loss``."""
    ref, per_rank, _ = runs
    want = _ref_tree(ref, f"grads_{key}/")
    _shards_close(per_rank, _case_index(key, mesh), want, _specs(key, mesh),
                  mesh, GRAD_REL)


@pytest.mark.parametrize("key,mesh", CASES,
                         ids=[f"{k}-{_mname(m)}" for k, m in CASES])
def test_two_steps_match_reference(runs, key, mesh):
    """Two steps of ``make_train_step(rules=)``: loss and grad norm of each
    step, and each rank's params and moments against the reference's plain
    jitted step (and its sharded one at (2, 2)); every rank the same
    metric bits."""
    ref, per_rank, _ = runs
    idx = _case_index(key, mesh)
    legs = [r[idx]["legs"][0] for r in per_rank]
    assert all(leg["bits"] == legs[0]["bits"] for leg in legs[1:])
    tags = [""] + (["sharded_"] if (key, mesh) == SHARDED_REF else [])
    specs = _specs(key, mesh)
    for tag in tags:
        metrics = ref[f"{tag}{key}_metrics"][:STEPS]
        got = np.array([legs[0]["loss"], legs[0]["grad_norm"]]).T
        np.testing.assert_allclose(got, metrics, **TOL)
        for rank, leg in enumerate(legs):
            _state_close(leg["state"], ref, f"{tag}{key}_{STEPS}", specs,
                         mesh, rank, STEPS)


@pytest.mark.parametrize("key,mesh", CASES,
                         ids=[f"{k}-{_mname(m)}" for k, m in CASES])
def test_replicas_stay_bitwise_equal(runs, key, mesh):
    """After two steps, the ranks holding the same block of a leaf (its
    replicas along an axis it is not split over) hold it bit for bit."""
    _, per_rank, _ = runs
    idx = _case_index(key, mesh)
    specs = _specs(key, mesh)
    for path, spec in specs.items():
        split = {a for e in spec if e for a in ((e,) if isinstance(e, str)
                                                 else e)}
        blocks = {}
        for rank, res in enumerate(per_rank):
            coords = _RankOf(mesh, rank).coords
            where = tuple(coords[a] for a in AXES if a in split)
            for pre in (".params::", ".opt::.mu::", ".opt::.nu::"):
                got = res[idx]["legs"][0]["state"][pre + path]
                if (pre, where) in blocks:
                    assert np.array_equal(blocks[(pre, where)], got), \
                        (pre + path, rank)
                blocks[(pre, where)] = got


def test_compression_matches_reference(runs):
    """``compression=True`` at (2, 2): the metrics and each rank's params,
    moments and error-feedback residual against the reference's plain
    step with compression."""
    ref, per_rank, _ = runs
    key, mesh = COMPRESS
    idx = len(CASES)
    legs = [r[idx]["legs"][0] for r in per_rank]
    assert all(leg["bits"] == legs[0]["bits"] for leg in legs[1:])
    got = np.array([legs[0]["loss"], legs[0]["grad_norm"]]).T
    np.testing.assert_allclose(got, ref[f"compress_{key}_metrics"], **TOL)
    specs = _specs(key, mesh)
    for rank, leg in enumerate(legs):
        _state_close(leg["state"], ref, f"compress_{key}_{STEPS}", specs,
                     mesh, rank, STEPS, ("mu", "nu", "ef"))


def test_mesh_checkpoint_restores_through_the_reference(runs):
    """The (2, 2) world's checkpoint at step 2 (rank 0 wrote whole
    leaves): the reference's ``restore`` reads every leaf, and each
    rank's block of it is that rank's state bit for bit."""
    _, per_rank, ckpt = runs
    flat, step, _ = jck.restore(str(ckpt), STEPS)
    assert step == STEPS
    idx = len(CASES) + 1
    mesh = ELASTIC_LEGS[0][0]
    specs = _specs(ELASTIC_KEY, mesh)
    sharded = (".params::", ".opt::.mu::", ".opt::.nu::")
    for rank, res in enumerate(per_rank):
        state = res[idx]["legs"][0]["state"]
        assert sorted(state) == sorted(flat)
        for k, got in state.items():
            pre = [p for p in sharded if k.startswith(p)]
            want = (_block(flat[k], specs[k[len(pre[0]):]], mesh, rank)
                    if pre else flat[k])
            assert got.dtype == want.dtype and np.array_equal(got, want), k


def test_reshard_restore_matches_an_uninterrupted_run(runs):
    """(2, 2) -> checkpoint -> ``reshard_restore`` onto (4, 1) ->
    checkpoint -> one device, 2 steps each: every step's metrics and the
    final state against the reference's 6 uninterrupted steps."""
    ref, per_rank, _ = runs
    idx = len(CASES) + 1
    n = sum(s for _, s in ELASTIC_LEGS)
    legs = per_rank[0][idx]["legs"]
    assert [leg["mesh"] for leg in legs] == [m for m, _ in ELASTIC_LEGS]
    got = np.array([[x for leg in legs for x in leg[k]]
                    for k in ("loss", "grad_norm")]).T
    np.testing.assert_allclose(got, ref[f"{ELASTIC_KEY}_metrics"], **TOL)
    for r in per_rank[1:]:
        assert [leg["bits"] for leg in r[idx]["legs"]] == \
            [leg["bits"] for leg in legs]
    for rank, r in enumerate(per_rank):
        _state_close(r[idx]["legs"][-1]["state"], ref, f"{ELASTIC_KEY}_{n}",
                     None, None, rank, n)


@pytest.mark.parametrize("mesh,axis", PSUM_CASES,
                         ids=[f"{_mname(m)}-{a}" for m, a in PSUM_CASES])
def test_compressed_psum_matches_reference(runs, mesh, axis):
    """Each rank's ``compressed_psum`` bit for bit the reference's
    ``shard_map`` on its device, and within ``PSUM_REL`` of the float
    sum over the axis."""
    ref, per_rank, _ = runs
    idx = len(CASES) + 2 + PSUM_CASES.index((mesh, axis))
    want = ref[f"psum_{_mname(mesh)}_{axis}"]
    x = _psum_inputs()
    for rank, res in enumerate(per_rank):
        got = res[idx]["out"]
        assert np.array_equal(got, want[rank]), rank
        coords = _RankOf(mesh, rank).coords
        peers = [r for r in range(4) if all(
            _RankOf(mesh, r).coords[a] == coords[a] for a in AXES
            if a != axis)]
        exact = x[peers].sum(0)
        assert float(np.abs(got - exact).max()) <= \
            PSUM_REL * float(np.abs(exact).max())


def test_mesh_run_resumes_bitwise(runs):
    """``launch/train.run(args, cfg, mesh=)`` at (2, 2) with
    ``--ckpt-dir``: a run of 2 steps (its checkpoint at step 2, rank 0
    writing whole leaves) then a run to 4 from the same directory restores
    each rank's shards at step 2 and ends in the uninterrupted run's
    losses and state bit for bit, on every rank."""
    _, per_rank, _ = runs
    idx = len(CASES) + 2 + len(PSUM_CASES)
    for rank, res in enumerate(per_rank):
        whole, first, resumed = res[idx:idx + 3]
        assert whole["restored_step"] is None and first["restored_step"] \
            is None and resumed["restored_step"] == 2, rank
        assert [h["step"] for h in resumed["history"]] == [2, 3]
        assert resumed["history"] == whole["history"][2:], rank
        assert first["history"] == whole["history"][:2], rank
        assert resumed["digests"] == whole["digests"], rank
    assert all(r[idx]["bits"] == per_rank[0][idx]["bits"] for r in per_rank)


def _act_seq_index(key, mesh):
    """(index of the run with ``"act_seq"`` on, of the run with it off)
    in the world's cases (:func:`_world_cases`)."""
    base = len(CASES) + 2 + len(PSUM_CASES) + 3
    if (key, mesh) in ACT_SEQ_CASES:
        return _case_index(key, mesh), base + ACT_SEQ_CASES.index((key,
                                                                  mesh))
    on = base + len(ACT_SEQ_CASES) + 2 * ACT_SEQ_PAIRS.index((key, mesh))
    return on, on + 1


def _act_seq_seq(key):
    if key in ACT_SEQ_CONFIGS:
        return ACT_SEQ_CONFIGS[key][1]
    return SEQ     # a vlm's image prefix is part of its SEQ positions


@pytest.mark.parametrize("key,mesh", ACT_SEQ_ALL,
                         ids=[f"{k}-{_mname(m)}" for k, m in ACT_SEQ_ALL])
def test_act_seq_matches_the_whole_carry(runs, key, mesh):
    """``"act_seq"`` on (``rules_for``'s default) against off
    (``overrides=ACT_SEQ_OFF``), from one state, on every rank, bit for
    bit: the first batch's gradient shards and metrics, each step's loss,
    aux and grad norm, and the params and moments after two steps."""
    _, per_rank, _ = runs
    i_on, i_off = _act_seq_index(key, mesh)
    for rank, res in enumerate(per_rank):
        on, off = res[i_on], res[i_off]
        assert on["grad_metrics"] == off["grad_metrics"], rank
        assert sorted(on["grads"]) == sorted(off["grads"])
        for path, g in on["grads"].items():
            assert np.array_equal(g, off["grads"][path]), (rank, path)
        a, b = on["legs"][0], off["legs"][0]
        assert (a["bits"], a["aux"], a["ce"]) == (b["bits"], b["aux"],
                                                  b["ce"]), rank
        assert sorted(a["state"]) == sorted(b["state"])
        for path, x in a["state"].items():
            assert np.array_equal(x, b["state"][path]), (rank, path)


@pytest.mark.parametrize("key,mesh", ACT_SEQ_ALL,
                         ids=[f"{k}-{_mname(m)}" for k, m in ACT_SEQ_ALL])
def test_act_seq_carries_the_ranks_rows(runs, key, mesh):
    """The layout log of every forward (2 microbatches of gradients, 2
    steps): with ``"act_seq"`` on each layer call (the hybrid's group and
    tail layer) receives the rank's S / 4 or S / 2 sequence rows (the
    vlm's S counts its image prefix), or the whole carry where the model
    axis does not divide S (18 at 4); with it off every carry is whole."""
    _, per_rank, _ = runs
    arch = (ACT_SEQ_CONFIGS[key][0] if key in ACT_SEQ_CONFIGS
            else CONFIGS[key][0])
    cfg = tget(arch).reduced()
    calls = (cfg.n_layers // 3 + cfg.n_layers % 3 if cfg.family == "hybrid"
             else cfg.n_layers)
    S, rows = _act_seq_seq(key), BATCH // MICRO // mesh[0]
    tp = mesh[1]
    split = S % tp == 0
    forwards = MICRO * (1 + STEPS)
    i_on, i_off = _act_seq_index(key, mesh)
    for rank, res in enumerate(per_rank):
        want_on = ([("rows", (rows, S // tp, cfg.d_model))] if split
                   else [("whole", (rows, S, cfg.d_model))])
        assert res[i_on]["carries"] == want_on * calls * forwards, rank
        assert res[i_off]["carries"] == \
            [("whole", (rows, S, cfg.d_model))] * calls * forwards, rank
