"""The hybrid and ssm families on a mesh (``models/ssm.py`` and
``models/rglru.py`` with ``rules``: the recurrent blocks channel parallel
over ``"model"``; ``manual_tp.decode_attention_ring``: the hybrid's ring
cache whole on every rank) against the JAX package, on the CPU.

One 4-rank gloo world of the port (``launch/mesh.spawn`` of
``launch/distributed.run_mesh_cases``, one thread a rank) and four
reference processes with four XLA host devices (unsharded, and sharded at
(1, 4), (2, 2) and (4, 1)), side by side, run the same cases from the same
numpy weights, in float32 compute.  The reduced configs:

* ``mamba``: falcon-mamba-7b as ``reduced()`` gives it (d_inner 128: 32
  channels a rank at a model axis of 4; ``in_proj``'s stored block holds
  columns of x on ranks 0-1 and of z on ranks 2-3);
* ``rg``: recurrentgemma-2b as ``reduced()`` gives it (lru_width 64, 4 / 1
  heads: the ``replicated`` attention layout at (1, 4));
* ``rg-h10``: ``rg`` with 10 / 1 heads, which a model axis of 4 does not
  split: the ``full`` layout that the full width takes at (1, 4).

Serving: a prefill of a batch of 4 prompts of 21 tokens (longer than the
reduced window of 16) and 4 teacher-forced decode steps, ``Model.logits``
and ``ContinuousBatcher(mesh=, rules=)``, each against the reference's
sharded run and its unsharded one within ``1e-5`` (the hybrid's tied
embedding: ``atol`` scaled by ``|max| / 3.5``), every rank the same bits;
the collectives of a decode step at (1, 4); each rank's blocks of the
weights and of the prefill's decode state against the reference's
``devices_indices_map``.  A 3-rank world at (1, 3), whose model axis
divides neither d_inner 128 nor lru_width 64 (nor the vocab, heads or
MLP), computes every block whole.

Training: from the reference's ``init_train_state(PRNGKey(0))``, batches
of 8 x 16 in 2 microbatches at (1, 4) and (2, 2): each rank's gradient
shards against its block of the reference's ``jax.value_and_grad`` of
``Model.loss``, within ``GRAD_REL`` of the leaf's largest entry; two steps
of ``make_train_step(rules=)``, each from a state both sides share (the
first from the initial state, the second from the port's unsharded state
after one step): ``loss``, ``ce`` and the grad norm against the
reference's, and each rank's params and moments at
``tests/test_torch_train_mesh.py``'s tolerances (AdamW's first-order
slack for the one update), every rank the same metric bits.  One step at a
time: the hybrid's first gradient has entries near AdamW's eps, where
``m / (sqrt(v) + eps)`` moves with float32 rounding and the second step's
moments no longer show it.
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
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.convert import (lm_params_from_arrays,  # noqa: E402
                                 train_state_from_arrays)
from repro_torch.launch import distributed as launcher  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.models.sharding import shard_by_spec  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.train.checkpoint import _flatten  # noqa: E402
from repro_torch.train.data import batch_for_step  # noqa: E402
from repro_torch.train.optimizer import AdamState, AdamW  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
AXES = ("data", "model")
MESHES = [(1, 4), (2, 2), (4, 1)]
F32 = 1e-5
MAMBA, RG = "falcon-mamba-7b", "recurrentgemma-2b"
#: (arch, fields replaced after ``reduced()``)
CONFIGS = {
    "mamba": (MAMBA, {}),
    "rg": (RG, {}),
    "rg-h10": (RG, {"n_heads": 10, "n_kv_heads": 1}),
}
CASES = [(k, m) for k in CONFIGS for m in MESHES]
#: the batcher, and the blocks of the weights and the decode state
SERVE_KEYS, SERVE_MESHES = ("mamba", "rg"), [(1, 4), (2, 2)]
BLOCK_CASES = [(k, m) for k in SERVE_KEYS for m in MESHES]
#: prompts longer than the hybrid's reduced window of 16; the 4x1 case
#: needs a batch the data axis of 4 splits
B, S, MAX_LEN, STEPS = 4, 21, 24, 4
SERVE_PROMPTS, SERVE_NEW, SERVE_BATCH = (5, 19, 12), 4, 2
#: a model axis of 3 divides neither d_inner 128 nor lru_width 64, nor the
#: padded vocab, the heads or the MLP: every rank computes the whole model
ODD_MESH = (1, 3)
#: training: (config key, mesh) of the gradient and step cases
TRAIN_CASES = [(k, m) for k in CONFIGS for m in [(1, 4), (2, 2)]]
SEQ, BATCH, MICRO, TRAIN_STEPS = 16, 8, 2, 2
LR = ("constant", (1e-3,))
GRAD_REL = 1e-5
#: ``tests/test_torch_train_mesh.py``'s step tolerances (see its TOL)
TOL = dict(rtol=1e-5, atol=1e-5)
NU_TOL = dict(rtol=1e-5, atol=1e-9)
WORLD_TIMEOUT_S = 120


def _mname(m):
    return f"{m[0]}x{m[1]}"


def _configs(key):
    """(reference cfg, port cfg) of a key, float32 compute."""
    arch, fields = CONFIGS[key]
    return tuple(dataclasses.replace(get(arch).reduced(),
                                     compute_dtype="float32", **fields)
                 for get in (jget, tget))


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


def _serve_prompts(key):
    jcfg, _ = _configs(key)
    rng = np.random.default_rng(9)
    return [rng.integers(0, jcfg.vocab, n).astype(np.int32)
            for n in SERVE_PROMPTS]


@pytest.fixture(scope="module")
def weights():
    return {key: _weights(key) for key in CONFIGS}


def _numpy_state(st):
    """A port ``TrainState`` as the numpy tree the reference reads."""
    def arr(tree):
        return None if tree is None else {
            k: arr(v) if isinstance(v, dict) else v.detach().numpy().copy()
            for k, v in tree.items()}
    return {"params": arr(st.params), "mu": arr(st.opt.mu),
            "nu": arr(st.opt.nu), "count": st.opt.count.numpy(),
            "master": None, "ef": None, "step": st.step.numpy()}


def _train_states(key):
    """The states each training step starts from, as numpy: the
    reference's ``init_train_state(PRNGKey(0))`` and the port's unsharded
    state one step after it."""
    jcfg, tcfg = _configs(key)
    js = jts.init_train_state(jbuild(jcfg), jax.random.PRNGKey(0),
                              jopt.AdamW())
    arr = lambda t: None if t is None else jax.tree.map(np.asarray, t)  # noqa
    s0 = {"params": arr(js.params), "mu": arr(js.opt.mu),
          "nu": arr(js.opt.nu), "count": arr(js.opt.count),
          "master": arr(js.opt.master), "ef": arr(js.ef),
          "step": arr(js.step)}
    st = train_state_from_arrays(**s0, device="cpu")
    step = tts.make_train_step(tbuild(tcfg), AdamW(),
                               getattr(topt, LR[0])(*LR[1]),
                               microbatches=MICRO)
    st, _ = step(st, batch_for_step(tcfg, ShapeConfig("t", "train", SEQ,
                                                      BATCH), 0,
                                    device="cpu"))
    return [s0, _numpy_state(st)]


# ---------------------------------------------------------------------------
# the port's cases and the reference's spec


def _teacher(key):
    tok, steps = _inputs(key)
    return {"tokens": tok, "steps": steps, "max_len": MAX_LEN,
            "state": True}


def _case(weights, key, mesh, **parts):
    return {"arch": CONFIGS[key][0], "reduced": True, "mesh": mesh,
            "config": {"compute_dtype": "float32", **CONFIGS[key][1]},
            "arrays": weights[key], **parts}


def _lm_cases(weights):
    cases = [_case(weights, key, m, teacher=_teacher(key),
                   logits={"tokens": _inputs(key)[0]}) for key, m in CASES]
    cases += [_case(weights, key, m, serve={
        "prompts": _serve_prompts(key), "batch": SERVE_BATCH,
        "max_len": MAX_LEN, "new": SERVE_NEW})
        for key in SERVE_KEYS for m in SERVE_MESHES]
    return cases


def _train_cases(states):
    return [{"arch": CONFIGS[k][0], "reduced": True,
             "config": {"compute_dtype": "float32", **CONFIGS[k][1]},
             "mesh": m, "state": states[k][s], "seq": SEQ, "batch": BATCH,
             "microbatches": MICRO, "lr": LR, "steps": 1, "first_step": s,
             "grads": s == 0}
            for k, m in TRAIN_CASES for s in range(TRAIN_STEPS)]


_REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs.base import get_config
    from repro.configs.shapes import ShapeConfig
    from repro.launch.mesh import compat_make_mesh, set_mesh
    from repro.launch.steps import rules_for
    from repro.models.factory import build_model, state_logical_axes
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
        arch, fields = spec["configs"][key]
        return dataclasses.replace(get_config(arch).reduced(),
                                   compute_dtype="float32", **fields)

    def weights(key):
        return unflat(dict(np.load(spec["weights"][key])), "", "/")

    def leaves(st):
        return {f"{part}/{name}": leaf for part in ("kv", "ssm", "lru")
                if getattr(st, part) is not None
                for name, leaf in zip(getattr(st, part)._fields,
                                      getattr(st, part))}

    def teacher(model, p, d, rules=None, mesh=None):
        b = jnp.asarray(np.asarray(d["tokens"]), jnp.int32)
        lg, st = jax.jit(lambda p, b: model.prefill(
            p, {"tokens": b}, max_len=d["max_len"], rules=rules))(p, b)
        state = {k: np.asarray(v) for k, v in leaves(st).items()}
        dec = jax.jit(lambda p, t, s: model.decode(p, t, s, mesh=mesh,
                                                   rules=rules))
        rows = []
        for r in d["steps"]:
            l, st = dec(p, jnp.asarray(np.asarray(r)[:, None], jnp.int32), st)
            rows.append(np.asarray(l))
        out_lg = np.asarray(jax.jit(lambda p, b: model.logits(
            p, {"tokens": b}, rules=rules, remat=False)[0])(p, b))
        return np.asarray(lg), np.stack(rows), out_lg, state

    def indices(sharding, shape):
        idx = sharding.devices_indices_map(shape)
        return np.asarray([[[sl.start or 0, n if sl.stop is None else sl.stop]
                            for sl, n in zip(idx[d], shape)]
                           for d in mesh.devices.flat])

    mesh = None
    if where != "local":
        mesh = compat_make_mesh(tuple(int(x) for x in where.split("x")),
                                ("data", "model"))
    for case in spec["teacher"]:
        if where not in case["meshes"] + ["local"]:
            continue
        key = case["key"]
        model = build_model(config(key))
        p = weights(key)
        if mesh is None:
            got = teacher(model, p, case)
        else:
            with set_mesh(mesh):
                got = teacher(model, p, case, rules_for(model.cfg, mesh),
                              mesh)
        for part, v in zip(("prefill", "decode", "logits"), got):
            out[f"{key}_{where}_{part}"] = v
        if mesh is None:
            for name, v in got[3].items():
                out[f"{key}_local_state/{name}"] = v

    if mesh is None:
        for s in spec["serve"]:
            model = build_model(config(s["key"]))
            bt = ContinuousBatcher(model, weights(s["key"]), s["batch"],
                                   s["max_len"])
            for rid, pr in enumerate(s["prompts"]):
                bt.submit(Request(rid=rid, prompt=np.asarray(pr, np.int32),
                                  max_new_tokens=s["new"]))
            got = bt.run()
            out[f"serve_{s['key']}"] = np.asarray(
                [got[r] for r in range(len(got))])

        t = spec["train"]
        shape = ShapeConfig("t", "train", t["seq"], t["batch"])
        lr = getattr(opt, t["lr"][0])(*t["lr"][1])
        mb = t["micro"]
        for key in t["keys"]:
            cfg = config(key)
            model = build_model(cfg)
            fn = jax.jit(make_train_step(model, opt.AdamW(), lr,
                                         microbatches=mb))
            for s_, path in enumerate(t["states"][key]):
                flat = dict(np.load(path))
                get = lambda pre: unflat(flat, pre, "::") or None
                st = TrainState(
                    params=get("params::"),
                    opt=AdamState(mu=get("mu::"), nu=get("nu::"),
                                  count=jnp.asarray(flat["count"]),
                                  master=None),
                    step=jnp.asarray(flat["step"]), ef=None)
                b = batch_for_step(cfg, shape, s_)
                if s_ == 0:
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
                st, m = fn(st, b)
                out[f"{key}_metrics{s_}"] = np.asarray(
                    [float(m[k]) for k in ("loss", "ce", "aux", "grad_norm")])
                for part, tree in (("params", st.params), ("mu", st.opt.mu),
                                   ("nu", st.opt.nu)):
                    for k, v in jax.tree_util.tree_leaves_with_path(tree):
                        out[f"{key}_{part}{s_}/" + "::".join(
                            str(p.key) for p in k)] = np.asarray(v)
    else:
        rules_of = lambda model: rules_for(model.cfg, mesh)  # noqa: E731
        for key in spec["indices"]:
            model = build_model(config(key))
            _, axes = model.init(jax.random.PRNGKey(0))
            rules = rules_of(model)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                    weights(key)):
                ax = axes
                for k in path:
                    ax = ax[k.key]
                out[f"idx_{key}_{where}_" + "/".join(k.key for k in path)] = \\
                    indices(NamedSharding(mesh, rules.spec(ax, leaf.shape)),
                            leaf.shape)
            specs = model.decode_state_specs(spec["batch"], spec["max_len"])
            st_axes = leaves(state_logical_axes(model, specs))
            for name, leaf in leaves(specs).items():
                out[f"sidx_{key}_{where}_{name}"] = indices(
                    NamedSharding(mesh, rules.spec(st_axes[name],
                                                   leaf.shape)), leaf.shape)
    np.savez(sys.argv[3], **out)
    print("REF_OK")
""")


def _ref_spec(tmp, weights, states):
    teacher = []
    for key in CONFIGS:
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
    for key, sts in states.items():
        states_at[key] = []
        for s, st in enumerate(sts):
            states_at[key].append(str(tmp / f"state_{key}_{s}.npz"))
            np.savez(states_at[key][-1], **{
                k: v for k, v in _flatten(st).items() if v is not None})
    return {"configs": CONFIGS, "weights": paths, "teacher": teacher,
            "serve": [{"key": k, "prompts": [p.tolist() for p in
                                             _serve_prompts(k)],
                       "batch": SERVE_BATCH, "max_len": MAX_LEN,
                       "new": SERVE_NEW} for k in SERVE_KEYS],
            "indices": list(SERVE_KEYS), "batch": B, "max_len": MAX_LEN,
            "train": {"keys": sorted({k for k, _ in TRAIN_CASES}),
                      "states": states_at, "seq": SEQ, "batch": BATCH,
                      "micro": MICRO, "lr": LR}}


def _odd_cases(weights):
    return [_case(weights, key, ODD_MESH, teacher=_teacher(key))
            for key in CONFIGS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, weights):
    """(reference npz, the port's per-rank LM results by case key, its
    per-rank train results, its per-rank (1, 3) results by key): the
    reference processes run while the port's worlds do."""
    tmp = tmp_path_factory.mktemp("recurrent_mesh")
    states = {k: _train_states(k) for k in CONFIGS}
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
        f"serve_{k}_{_mname(m)}" for k in SERVE_KEYS for m in SERVE_MESHES]
    lm = {k: [rank[0][i] for rank in both] for i, k in enumerate(keys)}
    train = [rank[1] for rank in both]
    odd = {k: [rank[i] for rank in odd] for i, k in enumerate(CONFIGS)}
    return want, lm, train, odd


def _close(got, want, key):
    """Within 1e-5; the hybrid's tied embedding scales ``atol`` by the
    logits' ``|max| / 3.5`` (rows of N(0, 1) make them ~10 times the
    untied's)."""
    _, tcfg = _configs(key)
    scale = max(1.0, float(np.abs(want).max()) / 3.5) \
        if tcfg.tie_embeddings else 1.0
    np.testing.assert_allclose(got, want, rtol=F32, atol=F32 * scale)


def _bits_equal(results, part, keys):
    for r in results[1:]:
        for k in keys:
            assert np.array_equal(r[part][k], results[0][part][k]), (part, k)


def _collectives(tcfg, mesh):
    """A decode step's collectives at a (1, model) mesh by construction:
    the embed's sum and the unembed's gather, and a layer's: the ssm
    block's exchange, ``x_proj`` sum and ``out_proj`` sum; a recurrent
    layer's ``out`` and MLP sums; an attention layer's output sum (none
    when its heads are computed whole) and MLP sum."""
    from repro_torch.models import manual_tp
    rules = tsteps.rules_for(tcfg, dict(zip(AXES, mesh)))
    if tcfg.family == "ssm":
        return 2 + 3 * tcfg.n_layers
    n_attn = tcfg.n_layers // 3
    attn = 1 + manual_tp.attn_eligible(tcfg, rules)
    return 2 + 2 * (tcfg.n_layers - n_attn) + attn * n_attn


# ---------------------------------------------------------------------------
# serving


@pytest.mark.parametrize("key,mesh", CASES,
                         ids=[f"{k}-{_mname(m)}" for k, m in CASES])
def test_prefill_and_decode_match_reference(runs, key, mesh):
    """The sharded prefill's last logits and 4 teacher-forced decode steps'
    logits, every row: against the reference's sharded run and its
    unsharded one; every rank the same bits; at (1, 4) the collectives of
    a decode step (:func:`_collectives`)."""
    ref, lm, _, _ = runs
    results = lm[f"{key}_{_mname(mesh)}"]
    _bits_equal(results, "teacher", ("prefill", "decode"))
    got = results[0]["teacher"]
    for where in (_mname(mesh), "local"):
        _close(got["prefill"], ref[f"{key}_{where}_prefill"], key)
        _close(got["decode"], ref[f"{key}_{where}_decode"], key)
    if mesh == (1, 4):
        _, tcfg = _configs(key)
        assert got["collectives_per_decode_step"] == \
            [_collectives(tcfg, mesh)] * STEPS


@pytest.mark.parametrize("key,mesh", CASES,
                         ids=[f"{k}-{_mname(m)}" for k, m in CASES])
def test_logits_match_reference(runs, key, mesh):
    """``Model.logits(rules=)`` (the training forward) against the
    reference's sharded and unsharded logits, every rank the same bits."""
    ref, lm, _, _ = runs
    results = lm[f"{key}_{_mname(mesh)}"]
    for r in results[1:]:
        assert np.array_equal(r["logits"], results[0]["logits"])
    for where in (_mname(mesh), "local"):
        _close(results[0]["logits"], ref[f"{key}_{where}_logits"], key)


@pytest.mark.parametrize("key,mesh", [(k, m) for k in SERVE_KEYS
                                      for m in SERVE_MESHES],
                         ids=[f"{k}-{_mname(m)}" for k in SERVE_KEYS
                              for m in SERVE_MESHES])
def test_batcher_on_a_mesh_matches_reference(runs, key, mesh):
    """``ContinuousBatcher(mesh=, rules=)``: every rank the same tokens,
    the reference's unsharded batcher's.  Three prompts at batch 2: a
    finished row's slot takes the next prompt's prefill state, its ``h``
    and ``conv`` channels on every rank."""
    ref, lm, _, _ = runs
    toks = [r["serve"]["tokens"] for r in lm[f"serve_{key}_{_mname(mesh)}"]]
    assert all(t == toks[0] for t in toks[1:])
    want = ref[f"serve_{key}"]
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


@pytest.mark.parametrize("key,mesh", BLOCK_CASES,
                         ids=[f"{k}-{_mname(m)}" for k, m in BLOCK_CASES])
def test_weights_shard_as_reference(runs, weights, key, mesh):
    """``lm_params_from_arrays(..., rules=)`` gives each rank the block of
    every leaf (``in_proj``, ``x_proj``, ``in_x``, ``out`` among them) that
    the reference's ``NamedSharding`` gives its device."""
    ref, _, _, _ = runs
    _, tcfg = _configs(key)
    tree = weights[key]
    for rank in range(4):
        rules = tsteps.rules_for(tcfg, _RankOf(mesh, rank))
        got = dict(_flat_arrays(lm_params_from_arrays(tree, tcfg, "cpu",
                                                      rules)))
        for path, whole in _flat_arrays(tree):
            idx = ref[f"idx_{key}_{_mname(mesh)}_{'/'.join(path)}"][rank]
            block = whole[tuple(slice(a, b) for a, b in idx)]
            np.testing.assert_array_equal(got[path].float().numpy(), block,
                                          err_msg=str(path))


@pytest.mark.parametrize("key,mesh", BLOCK_CASES,
                         ids=[f"{k}-{_mname(m)}" for k, m in BLOCK_CASES])
def test_decode_state_shards_as_reference(runs, key, mesh):
    """Each rank's decode state after the sharded prefill (the ssm's and
    the RG-LRU's ``h`` and ``conv`` over ``"inner"``, the hybrid's ring
    whole on its sequence and heads) is the block of the reference's
    unsharded prefill state that the reference's ``NamedSharding`` of the
    state gives its device, and ``Model.decode_state_init(rules=)`` has
    its shape."""
    ref, lm, _, _ = runs
    _, tcfg = _configs(key)
    model = tbuild(tcfg)
    for rank, r in enumerate(lm[f"{key}_{_mname(mesh)}"]):
        got = r["teacher"]["state"]
        rules = tsteps.rules_for(tcfg, _RankOf(mesh, rank))
        init = launcher._state_arrays(model.decode_state_init(
            B, MAX_LEN, device="cpu", rules=rules))
        assert sorted(got) == sorted(init)
        for name, leaf in got.items():
            idx = ref[f"sidx_{key}_{_mname(mesh)}_{name}"][rank]
            whole = ref[f"{key}_local_state/{name}"]
            block = whole[tuple(slice(a, b) for a, b in idx)]
            assert leaf.shape == init[name].shape == block.shape, name
            _close(leaf, block.astype(np.float32), key)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_whole_blocks_at_an_odd_model_axis(runs, key):
    """At (1, 3) the spec guard leaves every ``"inner"`` leaf, the vocab,
    the heads and the MLP whole: every rank computes the whole model with
    no collective, its logits within 1e-5 of the reference's unsharded
    ones, every rank the same bits."""
    ref, _, _, odd = runs
    results = odd[key]
    _bits_equal(results, "teacher", ("prefill", "decode"))
    got = results[0]["teacher"]
    for part in ("prefill", "decode"):
        _close(got[part], ref[f"{key}_local_{part}"], key)
    assert got["collectives_per_decode_step"] == [0] * STEPS


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


def _train_result(train, key, mesh, step):
    return [r[TRAIN_CASES.index((key, mesh)) * TRAIN_STEPS + step]
            for r in train]


@pytest.mark.parametrize("key,mesh", TRAIN_CASES,
                         ids=[f"{k}-{_mname(m)}" for k, m in TRAIN_CASES])
def test_gradient_shards_match_reference(runs, key, mesh):
    """Each rank's shard of the first batch's gradients (2 microbatches),
    ``in_proj``'s (through the exchange), ``x_proj``'s (through the sum)
    and the RG-LRU's among them, against its block of ``jax.grad`` of the
    reference's ``Model.loss``."""
    ref, _, train, _ = runs
    want = _ref_tree(ref, f"grads_{key}/")
    specs = _specs(key, mesh)
    for rank, res in enumerate(_train_result(train, key, mesh, 0)):
        got = res["grads"]
        assert sorted(got) == sorted(want)
        for path, whole in want.items():
            block = _block(whole, specs[path], mesh, rank)
            bound = GRAD_REL * float(np.abs(whole).max())
            err = float(np.abs(got[path] - block).max())
            assert err <= bound, (rank, path, err, bound)


@pytest.mark.parametrize("key,mesh", TRAIN_CASES,
                         ids=[f"{k}-{_mname(m)}" for k, m in TRAIN_CASES])
def test_two_steps_match_reference(runs, key, mesh):
    """Two steps of ``make_train_step(rules=)``, each from the state the
    reference's step starts from (module docstring): each step's ``loss``,
    ``ce``, ``aux`` and grad norm against the reference's, every rank the
    same bits; each rank's moments within TOL of its blocks of the
    reference's and its params within TOL plus AdamW's first-order slack
    from the moments' differences for the one update
    (``tests/test_torch_train_mesh.py``)."""
    ref, _, train, _ = runs
    specs = _specs(key, mesh)
    opt = AdamW()
    lr = getattr(topt, LR[0])(*LR[1])
    pre = {"params": ".params::", "mu": ".opt::.mu::", "nu": ".opt::.nu::"}
    for s in range(TRAIN_STEPS):
        legs = [r["legs"][0] for r in _train_result(train, key, mesh, s)]
        assert all(leg["bits"] == legs[0]["bits"] for leg in legs[1:])
        got = [legs[0][k][0] for k in ("loss", "ce", "aux", "grad_norm")]
        np.testing.assert_allclose(got, ref[f"{key}_metrics{s}"], **TOL)
        n = s + 1
        bc1, bc2 = 1 - opt.b1 ** n, 1 - opt.b2 ** n
        rate = float(lr(s))
        for rank, leg in enumerate(legs):
            st = leg["state"]
            w = {part: {p: _block(v, specs[p], mesh, rank) for p, v in
                        _ref_tree(ref, f"{key}_{part}{s}/").items()}
                 for part in pre}
            for part in ("mu", "nu"):
                for path, v in w[part].items():
                    np.testing.assert_allclose(
                        st[pre[part] + path], v,
                        **(NU_TOL if part == "nu" else TOL),
                        err_msg=f"step {s} {part} {path} rank {rank}")
            for path, v in w["params"].items():
                m, sd = w["mu"][path] / bc1, np.sqrt(w["nu"][path] / bc2)
                dm = np.abs(st[pre["mu"] + path] / bc1 - m)
                ds = np.abs(np.sqrt(st[pre["nu"] + path] / bc2) - sd)
                slack = rate * (dm / (sd + opt.eps) + np.abs(m) * ds
                                / (sd + opt.eps) ** 2)
                d = np.abs(st[pre["params"] + path] - v)
                bound = TOL["atol"] + TOL["rtol"] * np.abs(v) + slack
                assert (d <= bound).all(), (s, path, rank, float(d.max()))
