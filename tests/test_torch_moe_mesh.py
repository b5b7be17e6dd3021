"""The moe family on a mesh (``models/moe.apply_moe(rules=)``: experts
expert parallel over ``"model"``, the router gathered whole, the aux loss
of the global batch) against the JAX package, on the CPU.

One 4-rank gloo world of the port (``launch/mesh.spawn`` of
``launch/distributed.run_mesh_cases``, one thread a rank) and four
reference processes with four XLA host devices (unsharded, and sharded at
(1, 4), (2, 2) and (4, 1)), side by side, run the same cases from the same
numpy weights, in float32 compute.  The reduced configs:

* ``qwen3``: qwen3-moe-30b-a3b as ``reduced()`` gives it, 4 / 1 heads and
  4 experts top-2: one expert a rank at a model axis of 4;
* ``qwen3-e8``: 8 / 4 heads (the full width's ``heads`` layout) and 8
  experts, two a rank;
* ``qwen3-drop``: ``qwen3`` at ``capacity_factor`` 0.5, so that entries
  drop past capacity;
* ``phi35``: phi3.5-moe's reduced config, at (2, 2).

Serving: a prefill of a batch of 4 and 4 teacher-forced decode steps,
``Model.logits``, the chunked prefill and ``ContinuousBatcher(mesh=,
rules=)``, each against the reference's sharded run and its unsharded
one within ``1e-5``, every rank the same bits; the ranks' routing (the
share dropped and a hash of the picks, ``RouteLog``) equal and, where
entries drop, equal to one device's; each rank's blocks of the weights
against the reference's ``devices_indices_map``.  A 3-rank world at (1,
3), whose model axis divides neither the 4 experts nor the vocab nor the
heads, computes the experts whole on every rank.

Training: from the reference's ``init_train_state(PRNGKey(0))``, batches
of 8 x 16 in 2 microbatches at (1, 4) and (2, 2): each rank's gradient
shards (router included) against its block of the reference's
``jax.value_and_grad`` of ``Model.loss``, within ``GRAD_REL`` of the
leaf's largest entry; two steps of ``make_train_step(rules=)``: ``loss``,
``ce``, ``aux`` and the grad norm of each step against the reference's
(the aux counted once), and each rank's params and moments at
``tests/test_torch_train.py``'s tolerances; every rank the same metric
bits.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jget  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.launch import distributed as launcher  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import manual_tp  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.models.sharding import shard_by_spec  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.train.checkpoint import _flatten  # noqa: E402
from repro_torch.train.optimizer import AdamState, AdamW  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
AXES = ("data", "model")
MESHES = [(1, 4), (2, 2), (4, 1)]
F32 = 1e-5
QWEN, PHI = "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"
#: (arch, fields replaced after ``reduced()``, fields of its MoEConfig)
CONFIGS = {
    "qwen3": (QWEN, {}, {}),
    "qwen3-e8": (QWEN, {"n_heads": 8, "n_kv_heads": 4}, {"num_experts": 8}),
    "qwen3-drop": (QWEN, {}, {"capacity_factor": 0.5}),
    "phi35": (PHI, {}, {}),
}
#: (config key, mesh) of the teacher-forced cases (``Model.logits`` rides
#: each), then the chunked prefill's
TEACHER_CASES = [(k, m) for k in ("qwen3", "qwen3-e8", "qwen3-drop")
                 for m in MESHES] + [("phi35", (2, 2))]
CHUNK_KEY = "qwen3-e8"
CASES = TEACHER_CASES + [(f"chunk_{CHUNK_KEY}", m) for m in MESHES]
SERVE_KEY, SERVE_MESHES = "qwen3-e8", [(1, 4), (2, 2)]
#: the 4x1 teacher case needs a batch the data axis of 4 splits
B, S, MAX_LEN, STEPS = 4, 12, 16, 4
CHUNK_S, CHUNK, CHUNK_MAX_LEN = 16, 8, 24
SERVE_PROMPTS, SERVE_NEW, SERVE_BATCH = (5, 9, 12), 4, 2
#: a model axis of 3 divides neither the 4 experts nor the padded vocab
#: (256) nor the heads: each rank computes the whole layer, and only the
#: cache splits over it (18 slots)
ODD_MESH, ODD_KEYS, ODD_MAX_LEN = (1, 3), ("qwen3", "qwen3-drop"), 18
#: training: (config key, mesh) of the gradient and two-step cases
TRAIN_CASES = [(k, m) for k in ("qwen3", "qwen3-e8")
               for m in [(1, 4), (2, 2)]]
SEQ, BATCH, MICRO, TRAIN_STEPS = 16, 8, 2, 2
LR = ("warmup_cosine", (1e-2, 1, 4))
GRAD_REL = 1e-5
#: ``tests/test_torch_train_mesh.py``'s step tolerances (see its TOL)
TOL = dict(rtol=1e-5, atol=1e-5)
NU_TOL = dict(rtol=1e-5, atol=1e-9)
WORLD_TIMEOUT_S = 120


def _mname(m):
    return f"{m[0]}x{m[1]}"


def _configs(key):
    """(reference cfg, port cfg) of a key, float32 compute."""
    arch, fields, moe = CONFIGS[key]
    out = []
    for get in (jget, tget):
        cfg = get(arch).reduced()
        out.append(dataclasses.replace(
            cfg, compute_dtype="float32", **fields,
            moe=dataclasses.replace(cfg.moe, **moe)))
    return tuple(out)


def _port_config(key):
    """The fields ``run_lm_cases`` replaces after ``reduced()``."""
    _, tcfg = _configs(key)
    return {"compute_dtype": "float32", **CONFIGS[key][1], "moe": tcfg.moe}


def _arrays(tree):
    return {k: _arrays(v) if isinstance(v, dict) else v.float().numpy()
            for k, v in tree.items()}


def _weights(key):
    """Seeded weights as numpy (the port's ``init``, the reference's scales
    and layouts; the norms perturbed from their ones)."""
    _, tcfg = _configs(key)
    tree = _arrays(tbuild(tcfg).init(
        torch.Generator().manual_seed(len(key)), "cpu"))
    rng = np.random.default_rng(len(key))

    def perturb(t):
        return {k: perturb(v) if isinstance(v, dict) else
                (v * rng.uniform(0.5, 1.5, v.shape)).astype(v.dtype)
                if k == "scale" else v for k, v in t.items()}
    return perturb(tree)


def _flat_arrays(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_arrays(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _inputs(key):
    """The teacher case's tokens [B, S] and 4 rows of decode tokens."""
    jcfg, _ = _configs(key)
    rng = np.random.default_rng(7)
    return (rng.integers(0, jcfg.vocab, (B, S)),
            rng.integers(0, jcfg.vocab, (STEPS, B)))


def _chunk_inputs(key):
    jcfg, _ = _configs(key)
    rng = np.random.default_rng(8)
    return (rng.integers(0, jcfg.vocab, (B, CHUNK_S)),
            rng.integers(0, jcfg.vocab, (STEPS, B)))


def _serve_prompts():
    jcfg, _ = _configs(SERVE_KEY)
    rng = np.random.default_rng(9)
    return [rng.integers(0, jcfg.vocab, n).astype(np.int32)
            for n in SERVE_PROMPTS]


@pytest.fixture(scope="module")
def weights():
    return {key: _weights(key) for key in CONFIGS}


def _init_state(key):
    """The reference's initial train state as numpy (``PRNGKey(0)``)."""
    jcfg, _ = _configs(key)
    js = jts.init_train_state(jbuild(jcfg), jax.random.PRNGKey(0),
                              jopt.AdamW())
    arr = lambda t: None if t is None else jax.tree.map(np.asarray, t)  # noqa
    return {"params": arr(js.params), "mu": arr(js.opt.mu),
            "nu": arr(js.opt.nu), "count": arr(js.opt.count),
            "master": arr(js.opt.master), "ef": arr(js.ef),
            "step": arr(js.step)}


# ---------------------------------------------------------------------------
# the port's cases and the reference's spec


def _teacher(key):
    if key.startswith("chunk_"):
        tok, steps = _chunk_inputs(key.removeprefix("chunk_"))
        return {"tokens": tok, "steps": steps, "max_len": CHUNK_MAX_LEN,
                "chunk": CHUNK}
    tok, steps = _inputs(key)
    return {"tokens": tok, "steps": steps, "max_len": MAX_LEN}


def _case(weights, key, mesh, **parts):
    base = key.removeprefix("chunk_")
    return {"arch": CONFIGS[base][0], "reduced": True, "mesh": mesh,
            "config": _port_config(base), "arrays": weights[base],
            "routing": True, **parts}


def _lm_cases(weights):
    cases = []
    for key, m in CASES:
        parts = {"teacher": _teacher(key)}
        if not key.startswith("chunk_"):
            parts["logits"] = {"tokens": _inputs(key)[0]}
        cases.append(_case(weights, key, m, **parts))
    cases += [_case(weights, SERVE_KEY, m, serve={
        "prompts": _serve_prompts(), "batch": SERVE_BATCH,
        "max_len": MAX_LEN, "new": SERVE_NEW}) for m in SERVE_MESHES]
    return cases


def _train_cases(states):
    return [{"arch": CONFIGS[k][0], "reduced": True,
             "config": _port_config(k), "mesh": m, "state": states[k],
             "seq": SEQ, "batch": BATCH, "microbatches": MICRO, "lr": LR,
             "steps": TRAIN_STEPS, "grads": True, "routing": True}
            for k, m in TRAIN_CASES]


_REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs.base import get_config
    from repro.configs.shapes import ShapeConfig
    from repro.launch.mesh import compat_make_mesh, set_mesh
    from repro.launch.steps import rules_for
    from repro.models import transformer as tfm
    from repro.models.factory import build_model
    from repro.serve.engine import ContinuousBatcher, Request
    from repro.train import optimizer as opt
    from repro.train.data import batch_for_step
    from repro.train.optimizer import AdamState
    from repro.train.train_step import TrainState, make_train_step

    spec = json.loads(open(sys.argv[1]).read())
    where = sys.argv[2]           # "local" or a mesh "DxM"
    out = {}

    def unflat(flat, prefix, sep):
        tree = {}
        for k, v in flat.items():
            if not k.startswith(prefix):
                continue
            node = tree
            *head, last = k[len(prefix):].split(sep)
            for h in head:
                node = node.setdefault(h, {})
            node[last] = jnp.asarray(v)
        return tree

    def config(key):
        arch, fields, moe = spec["configs"][key]
        cfg = get_config(arch).reduced()
        return dataclasses.replace(cfg, compute_dtype="float32", **fields,
                                   moe=dataclasses.replace(cfg.moe, **moe))

    def weights(key):
        return unflat(dict(np.load(spec["weights"][key])), "", "/")

    def teacher(model, p, d, rules=None, mesh=None):
        b = jnp.asarray(np.asarray(d["tokens"]), jnp.int32)
        chunk = d.get("chunk")
        if chunk:
            pf = lambda p, b: tfm.prefill(p, model.cfg, b,
                                          max_len=d["max_len"], rules=rules,
                                          chunk=chunk)
        else:
            pf = lambda p, b: model.prefill(p, {"tokens": b},
                                            max_len=d["max_len"],
                                            rules=rules)
        lg, st = jax.jit(pf)(p, b)
        dec = jax.jit(lambda p, t, s: model.decode(p, t, s, mesh=mesh,
                                                   rules=rules))
        rows = []
        for r in d["steps"]:
            l, st = dec(p, jnp.asarray(np.asarray(r)[:, None], jnp.int32), st)
            rows.append(np.asarray(l))
        out_lg = None
        if not chunk:
            out_lg = np.asarray(jax.jit(lambda p, b: model.logits(
                p, {"tokens": b}, rules=rules, remat=False)[0])(p, b))
        return np.asarray(lg), np.stack(rows), out_lg

    mesh = None
    if where != "local":
        mesh = compat_make_mesh(tuple(int(x) for x in where.split("x")),
                                ("data", "model"))
    for case in spec["teacher"]:
        if where not in case["meshes"] + ["local"]:
            continue
        key = case["key"]
        model = build_model(config(key.removeprefix("chunk_")))
        p = weights(key.removeprefix("chunk_"))
        if mesh is None:
            got = teacher(model, p, case)
        else:
            with set_mesh(mesh):
                got = teacher(model, p, case, rules_for(model.cfg, mesh),
                              mesh)
        for part, v in zip(("prefill", "decode", "logits"), got):
            if v is not None:
                out[f"{key}_{where}_{part}"] = v

    if mesh is None:
        s = spec["serve"]
        model = build_model(config(s["key"]))
        bt = ContinuousBatcher(model, weights(s["key"]), s["batch"],
                               s["max_len"])
        for rid, pr in enumerate(s["prompts"]):
            bt.submit(Request(rid=rid, prompt=np.asarray(pr, np.int32),
                              max_new_tokens=s["new"]))
        got = bt.run()
        out["serve_tokens"] = np.asarray([got[r] for r in range(len(got))])

        t = spec["train"]
        shape = ShapeConfig("t", "train", t["seq"], t["batch"])
        lr = getattr(opt, t["lr"][0])(*t["lr"][1])
        mb = t["micro"]
        for key in t["keys"]:
            cfg = config(key)
            model = build_model(cfg)
            flat = dict(np.load(t["states"][key]))
            get = lambda pre: unflat(flat, pre, "::") or None
            st = TrainState(
                params=get("params::"),
                opt=AdamState(mu=get("mu::"), nu=get("nu::"),
                              count=jnp.asarray(flat["count"]), master=None),
                step=jnp.asarray(flat["step"]), ef=None)
            b = batch_for_step(cfg, shape, 0)
            per = t["batch"] // mb
            g = None
            grad = jax.jit(jax.grad(lambda p, x: model.loss(p, x)[0]))
            for i in range(mb):
                gi = grad(st.params, {k: v[i * per:(i + 1) * per]
                                      for k, v in b.items()})
                g = gi if g is None else jax.tree.map(jnp.add, g, gi)
            for k, v in jax.tree_util.tree_leaves_with_path(
                    jax.tree.map(lambda x: x / mb, g)):
                out[f"grads_{key}/" + "::".join(
                    str(p.key) for p in k)] = np.asarray(v)
            fn = jax.jit(make_train_step(model, opt.AdamW(), lr,
                                         microbatches=mb))
            metrics = []
            for s_ in range(t["steps"]):
                st, m = fn(st, batch_for_step(cfg, shape, s_))
                metrics.append([float(m[k]) for k in
                                ("loss", "ce", "aux", "grad_norm")])
            out[f"{key}_metrics"] = np.asarray(metrics)
            for part, tree in (("params", st.params), ("mu", st.opt.mu),
                               ("nu", st.opt.nu)):
                for k, v in jax.tree_util.tree_leaves_with_path(tree):
                    out[f"{key}_{part}/" + "::".join(
                        str(p.key) for p in k)] = np.asarray(v)
    else:
        key = spec["indices"]
        model = build_model(config(key))
        _, axes = model.init(jax.random.PRNGKey(0))
        rules = rules_for(model.cfg, mesh)
        for path, leaf in jax.tree_util.tree_leaves_with_path(weights(key)):
            ax = axes
            for k in path:
                ax = ax[k.key]
            idx = NamedSharding(mesh, rules.spec(ax, leaf.shape)
                                ).devices_indices_map(leaf.shape)
            out[f"idx_{where}_" + "/".join(k.key for k in path)] = np.asarray(
                [[[sl.start or 0, n if sl.stop is None else sl.stop]
                  for sl, n in zip(idx[d], leaf.shape)]
                 for d in mesh.devices.flat])
    np.savez(sys.argv[3], **out)
    print("REF_OK")
""")


def _ref_spec(tmp, weights, states):
    teacher = []
    for key in dict.fromkeys(k for k, _ in CASES):
        d = _teacher(key)
        teacher.append({"key": key, **{k: np.asarray(v).tolist()
                                        if k in ("tokens", "steps") else v
                                        for k, v in d.items()},
                        "meshes": [_mname(m) for k, m in CASES
                                   if k == key]})
    paths = {}
    for key, tree in weights.items():
        paths[key] = str(tmp / f"w_{key}.npz")
        np.savez(paths[key], **{"/".join(k): v
                                for k, v in _flat_arrays(tree)})
    states_at = {}
    for key, st in states.items():
        states_at[key] = str(tmp / f"state_{key}.npz")
        np.savez(states_at[key], **{k: v for k, v in _flatten(st).items()
                                    if v is not None})
    return {"configs": CONFIGS, "weights": paths, "teacher": teacher,
            "serve": {"key": SERVE_KEY, "prompts": [p.tolist() for p in
                                                    _serve_prompts()],
                      "batch": SERVE_BATCH, "max_len": MAX_LEN,
                      "new": SERVE_NEW},
            "indices": SERVE_KEY,
            "train": {"keys": sorted({k for k, _ in TRAIN_CASES}),
                      "states": states_at, "seq": SEQ, "batch": BATCH,
                      "micro": MICRO, "lr": LR, "steps": TRAIN_STEPS}}


def _odd_cases(weights):
    return [_case(weights, key, ODD_MESH, teacher={
        **_teacher(key), "max_len": ODD_MAX_LEN}) for key in ODD_KEYS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, weights):
    """(reference npz, the port's per-rank LM results by case key, its
    per-rank train results, its per-rank (1, 3) results by key): the
    reference processes run while the port's worlds do."""
    tmp = tmp_path_factory.mktemp("moe_mesh")
    states = {k: _init_state(k) for k, _ in TRAIN_CASES}
    (tmp / "spec.json").write_text(json.dumps(_ref_spec(tmp, weights,
                                                        states)))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    parts = ["local"] + [_mname(m) for m in MESHES]
    refs = [subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp / "spec.json"), part,
         str(tmp / f"ref_{part}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for part in parts]
    try:
        both = tmesh.spawn(launcher.run_mesh_cases, 4, "gloo", args=(
            _lm_cases(weights), _train_cases(states), "cpu"),
            timeout_s=WORLD_TIMEOUT_S)
        odd = tmesh.spawn(launcher.run_lm_cases, 3, "gloo",
                          args=(_odd_cases(weights), "cpu"),
                          timeout_s=WORLD_TIMEOUT_S)
        for ref in refs:
            out, err = ref.communicate(timeout=600)
            assert ref.returncode == 0 and "REF_OK" in out, err[-3000:]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    want = {}
    for part in parts:
        want.update(np.load(tmp / f"ref_{part}.npz"))
    keys = [f"{k}_{_mname(m)}" for k, m in CASES] + [
        f"serve_{_mname(m)}" for m in SERVE_MESHES]
    lm = {k: [rank[0][i] for rank in both] for i, k in enumerate(keys)}
    train = [rank[1] for rank in both]
    odd = {k: [rank[i] for rank in odd] for i, k in enumerate(ODD_KEYS)}
    return want, lm, train, odd


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=F32, atol=F32)


def _bits_equal(results, part, keys):
    for r in results[1:]:
        for k in keys:
            assert np.array_equal(r[part][k], results[0][part][k]), (part, k)


def _expert_parallel(tcfg, mesh):
    tp = mesh[1]
    return tp > 1 and tcfg.moe.num_experts % tp == 0


# ---------------------------------------------------------------------------
# serving


@pytest.mark.parametrize("key,mesh", CASES,
                         ids=[f"{k}-{_mname(m)}" for k, m in CASES])
def test_prefill_and_decode_match_reference(runs, key, mesh):
    """The sharded prefill's last logits and 4 teacher-forced decode steps'
    logits, every row: against the reference's sharded run and its
    unsharded one; every rank the same bits.  At (1, 4) a decode step
    makes the embed's sum and the unembed's gather, and a layer the
    partitioned softmax's gather, the attention's q/k/v gather and
    output sum, and where the experts split the router's gather and the
    experts' sum."""
    ref, lm, _, _ = runs
    results = lm[f"{key}_{_mname(mesh)}"]
    _bits_equal(results, "teacher", ("prefill", "decode"))
    got = results[0]["teacher"]
    for where in (_mname(mesh), "local"):
        _close(got["prefill"], ref[f"{key}_{where}_prefill"])
        _close(got["decode"], ref[f"{key}_{where}_decode"])
    if mesh == (1, 4):
        _, tcfg = _configs(key.removeprefix("chunk_"))
        rules = tsteps.rules_for(tcfg, dict(zip(AXES, mesh)))
        layer = 1 + 2 * manual_tp.attn_eligible(tcfg, rules) + \
            2 * _expert_parallel(tcfg, mesh)
        assert got["collectives_per_decode_step"] == \
            [2 + layer * tcfg.n_layers] * STEPS


@pytest.mark.parametrize("key,mesh", TEACHER_CASES,
                         ids=[f"{k}-{_mname(m)}" for k, m in TEACHER_CASES])
def test_logits_match_reference(runs, key, mesh):
    """``Model.logits(rules=)`` (the training forward, the aux loss's
    statistics summed over ``"data"``) against the reference's sharded
    and unsharded logits."""
    ref, lm, _, _ = runs
    results = lm[f"{key}_{_mname(mesh)}"]
    for r in results[1:]:
        assert np.array_equal(r["logits"], results[0]["logits"])
    for where in (_mname(mesh), "local"):
        _close(results[0]["logits"], ref[f"{key}_{where}_logits"])


def _one_device_routing(weights, key):
    """The port's routing of the teacher case on one device (the CPU)."""
    _, tcfg = _configs(key)
    model = tbuild(tcfg)
    p = lm_params_from_arrays(weights[key], tcfg, "cpu")
    tok, steps = _inputs(key)
    with torch.inference_mode(), launcher.RouteLog() as rl:
        _, st = model.prefill(p, {"tokens": torch.as_tensor(tok)},
                              max_len=MAX_LEN)
        for row in steps:
            _, st = model.decode(p, torch.as_tensor(row[:, None]), st)
        model.logits(p, {"tokens": torch.as_tensor(tok)}, remat=False)
    return rl.summary()


@pytest.mark.parametrize("key", ["qwen3", "qwen3-drop"])
def test_routing_is_the_one_devices(runs, weights, key):
    """At (1, 4) every rank routes every row: each rank's routing (calls,
    entries dropped, the picks' hash) equals one device's, and the drop
    case drops entries; at (2, 2) the ranks of one data coordinate route
    alike."""
    _, lm, _, _ = runs
    want = _one_device_routing(weights, key)
    if key == "qwen3-drop":
        assert want["dropped"] > 0
    for r in lm[f"{key}_1x4"]:
        assert r["routing"] == want
    by_row = {}
    for rank, r in enumerate(lm[f"{key}_2x2"]):
        row = by_row.setdefault(rank // 2, r["routing"])
        assert r["routing"] == row


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=_mname)
def test_batcher_on_a_mesh_matches_reference(runs, mesh):
    """``ContinuousBatcher(mesh=, rules=)``: every rank the same tokens,
    the reference's unsharded batcher's."""
    ref, lm, _, _ = runs
    toks = [r["serve"]["tokens"] for r in lm[f"serve_{_mname(mesh)}"]]
    assert all(t == toks[0] for t in toks[1:])
    want = ref["serve_tokens"]
    assert [toks[0][i] for i in range(len(want))] == want.tolist()


class _RankOf:
    """Where rank ``rank`` of a ``(data, model)`` mesh sits, without a
    world: what ``local_shard`` reads of a ``launch/mesh.Mesh``."""
    index = tmesh.Mesh.index

    def __init__(self, shape, rank):
        self.axis_names = AXES
        self.shape = dict(zip(AXES, shape))
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(
            rank, shape))))


@pytest.mark.parametrize("mesh", MESHES, ids=_mname)
def test_weights_shard_as_reference(runs, weights, mesh):
    """``lm_params_from_arrays(..., rules=)`` gives each rank the block of
    every leaf (``router``, ``wi``, ``wg``, ``wo`` among them) that the
    reference's ``NamedSharding`` gives its device."""
    ref, _, _, _ = runs
    _, tcfg = _configs(SERVE_KEY)
    tree = weights[SERVE_KEY]
    for rank in range(4):
        rules = tsteps.rules_for(tcfg, _RankOf(mesh, rank))
        got = dict(_flat_arrays(lm_params_from_arrays(tree, tcfg, "cpu",
                                                      rules)))
        for path, whole in _flat_arrays(tree):
            idx = ref[f"idx_{_mname(mesh)}_{'/'.join(path)}"][rank]
            block = whole[tuple(slice(a, b) for a, b in idx)]
            np.testing.assert_array_equal(got[path].float().numpy(), block,
                                          err_msg=str(path))


@pytest.mark.parametrize("key", ODD_KEYS)
def test_replicated_experts_at_an_odd_model_axis(runs, key):
    """At (1, 3) the spec guard leaves the 4 experts, the router, the
    vocab and the heads whole: every rank computes the whole layer with
    no sum, its logits within 1e-5 of the reference's unsharded ones,
    every rank the same bits, and a decode step makes only the
    partitioned softmax's gather a layer."""
    ref, _, _, odd = runs
    results = odd[key]
    _bits_equal(results, "teacher", ("prefill", "decode"))
    got = results[0]["teacher"]
    for part in ("prefill", "decode"):
        _close(got[part], ref[f"{key}_local_{part}"])
    _, tcfg = _configs(key)
    assert got["collectives_per_decode_step"] == [tcfg.n_layers] * STEPS
    assert all(r["routing"] == results[0]["routing"] for r in results)


# ---------------------------------------------------------------------------
# training


def _ref_tree(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _specs(key, mesh):
    """``{params leaf path: spec}`` of a config at a mesh."""
    _, tcfg = _configs(key)
    model = tbuild(tcfg)
    rules = tsteps.rules_for(tcfg, dict(zip(AXES, mesh)))
    specs = tts.state_shardings(tts.TrainState(
        params=model.param_shapes(), opt=AdamState(None, None, None),
        step=None), model.param_axes(), rules)
    return dict(_flatten(specs.params, specs=True))


def _block(whole, spec, mesh, rank):
    return shard_by_spec(torch.from_numpy(np.asarray(whole)), spec,
                         _RankOf(mesh, rank)).numpy()


@pytest.mark.parametrize("key,mesh", TRAIN_CASES,
                         ids=[f"{k}-{_mname(m)}" for k, m in TRAIN_CASES])
def test_gradient_shards_match_reference(runs, key, mesh):
    """Each rank's shard of the first batch's gradients (2 microbatches),
    the router's and the experts' among them, against its block of
    ``jax.grad`` of the reference's ``Model.loss``; the ranks' routing
    equal along the model axis."""
    ref, _, train, _ = runs
    idx = TRAIN_CASES.index((key, mesh))
    want = _ref_tree(ref, f"grads_{key}/")
    specs = _specs(key, mesh)
    assert any(p.endswith("router") for p in want)
    for rank, res in enumerate(train):
        got = res[idx]["grads"]
        assert sorted(got) == sorted(want)
        for path, whole in want.items():
            block = _block(whole, specs[path], mesh, rank)
            bound = GRAD_REL * float(np.abs(whole).max())
            err = float(np.abs(got[path] - block).max())
            assert err <= bound, (rank, path, err, bound)
        peer = train[rank - rank % mesh[1]][idx]["routing"]
        assert res[idx]["routing"] == peer


def _lr_sum(n):
    lr = getattr(topt, LR[0])(*LR[1])
    return sum(float(lr(s)) for s in range(n))


@pytest.mark.parametrize("key,mesh", TRAIN_CASES,
                         ids=[f"{k}-{_mname(m)}" for k, m in TRAIN_CASES])
def test_two_steps_match_reference(runs, key, mesh):
    """Two steps of ``make_train_step(rules=)``: each step's ``loss``,
    ``ce``, ``aux`` (the global batch's, counted once in ``loss``) and
    grad norm against the reference's plain jitted step, every rank the
    same bits; each rank's moments within TOL of its blocks of the
    reference's and its params within TOL plus AdamW's first-order slack
    from the moments' differences (``tests/test_torch_train_mesh.py``)."""
    ref, _, train, _ = runs
    idx = TRAIN_CASES.index((key, mesh))
    legs = [r[idx]["legs"][0] for r in train]
    assert all(leg["bits"] == legs[0]["bits"] for leg in legs[1:])
    got = np.array([legs[0][k] for k in ("loss", "ce", "aux",
                                         "grad_norm")]).T
    want = ref[f"{key}_metrics"]
    np.testing.assert_allclose(got, want, **TOL)
    first = train[0][idx]["grad_metrics"]
    np.testing.assert_allclose([first[k] for k in ("loss", "ce", "aux")],
                               want[0, :3], **TOL)
    np.testing.assert_allclose(got[:, 0], got[:, 1] + 0.01 * got[:, 2],
                               rtol=1e-6)
    specs = _specs(key, mesh)
    opt = AdamW()
    n = TRAIN_STEPS
    bc1, bc2 = 1 - opt.b1 ** n, 1 - opt.b2 ** n
    lr = _lr_sum(n)
    pre = {"params": ".params::", "mu": ".opt::.mu::", "nu": ".opt::.nu::"}
    for rank, leg in enumerate(legs):
        st = leg["state"]
        w = {part: {p: _block(v, specs[p], mesh, rank) for p, v in
                    _ref_tree(ref, f"{key}_{part}/").items()}
             for part in pre}
        for part in ("mu", "nu"):
            for path, v in w[part].items():
                np.testing.assert_allclose(
                    st[pre[part] + path], v,
                    **(NU_TOL if part == "nu" else TOL),
                    err_msg=f"{part} {path} rank {rank}")
        for path, v in w["params"].items():
            m, s = w["mu"][path] / bc1, np.sqrt(w["nu"][path] / bc2)
            dm = np.abs(st[pre["mu"] + path] / bc1 - m)
            ds = np.abs(np.sqrt(st[pre["nu"] + path] / bc2) - s)
            slack = lr * (dm / (s + opt.eps) + np.abs(m) * ds
                          / (s + opt.eps) ** 2)
            d = np.abs(st[pre["params"] + path] - v)
            bound = TOL["atol"] + TOL["rtol"] * np.abs(v) + slack
            assert (d <= bound).all(), (path, rank, float(d.max()))
