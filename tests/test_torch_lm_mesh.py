"""The LM on a mesh (``models/sharding``, ``models/manual_tp``,
``Model.prefill/decode/logits(rules=, mesh=)``, ``ContinuousBatcher(mesh=,
rules=)``) against the JAX package, on the CPU.

* Without a world: ``AxisRules.spec`` against the reference's
  ``PartitionSpec`` for every leaf of every registered config at meshes
  (1, 4), (2, 2), (4, 1) and (16, 16); the param axes, the state and
  batch axes and ``effective_microbatches`` against the reference's; each
  rank's block of the weights against the reference's
  ``NamedSharding.devices_indices_map``; hybrid and ssm on rank 0 of a
  model axis of 4 return its blocks (their values on a mesh:
  ``tests/test_torch_recurrent_mesh.py``; moe:
  ``tests/test_torch_moe_mesh.py``); a disagreement between ranks
  raises.
* One 4-rank gloo world of the port (``launch/mesh.spawn``, one thread a
  rank) and one reference process with four XLA host devices, side by
  side, run the same cases from the same numpy weights (the reference's
  ``init(PRNGKey(0))``, norms and QKV biases perturbed, carried across by
  ``convert.lm_params_from_arrays(..., rules=)``), in float32 compute:
  at meshes (1, 4) and (2, 2), a prefill of two prompts and 4
  teacher-forced decode steps for reduced starcoder2-7b in the kv
  layouts of ``manual_tp`` (the reference's three) and a block computed
  replicated, whisper-base and paligemma-3b; the chunked prefill;
  ``Model.logits`` with manual TP for reduced qwen2-72b and stablelm-12b;
  the batcher's tokens.  Each is held against the reference's sharded run
  (``jax.jit`` under ``set_mesh``) and its unsharded one within ``1e-5``
  (the tied embeddings' larger logits: ``atol`` scaled by
  ``|max| / 3.5``, as ``test_torch_vlm.py``), and every rank returns the
  same bits.
* One 3-rank world at mesh (1, 3), whose model axis divides neither the
  vocab nor the heads nor the MLP: the teacher cases of starcoder2-7b and
  paligemma-3b against the reference's unsharded run.
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
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import factory as jfactory  # noqa: E402
from repro.models import sharding as jsharding  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.configs.shapes import SHAPES as TSHAPES  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.launch import distributed as launcher  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import manual_tp  # noqa: E402
from repro_torch.models import sharding as tsharding  # noqa: E402
from repro_torch.models import factory as tfactory  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
AXES = ("data", "model")
SPEC_MESHES = [(1, 4), (2, 2), (4, 1), (16, 16)]
MESHES = [(1, 4), (2, 2)]
F32 = 1e-5
#: reduced configs of the world's cases: (arch, fields replaced after
#: ``reduced()``).  starcoder2's 4 / 1 heads of 16 split the head dim at a
#: model axis of 4 and 2 in the reference, and the port projects the kv
#: heads whole and slices the group; 8 / 4 heads split the kv heads (the
#: full width's layout: 9 / 1 a rank); head dim 18 at 4 ranks keeps the kv
#: weights replicated in both; 6 / 2 heads do not divide 4 ranks, so the
#: block is computed replicated
CONFIGS = {
    "starcoder2": ("starcoder2-7b", {}),
    "starcoder2-kv4": ("starcoder2-7b", {"n_heads": 8, "n_kv_heads": 4}),
    "starcoder2-hd18": ("starcoder2-7b", {"head_dim": 18}),
    "starcoder2-h6": ("starcoder2-7b", {"n_heads": 6, "n_kv_heads": 2}),
    "whisper": ("whisper-base", {}),
    "paligemma": ("paligemma-3b", {}),
    "qwen2": ("qwen2-72b", {}),
    "stablelm": ("stablelm-12b", {}),
}
TEACHER = ["starcoder2", "starcoder2-kv4", "starcoder2-hd18", "starcoder2-h6",
           "whisper", "paligemma"]
CHUNKED = ["starcoder2", "starcoder2-kv4"]
MANUAL = ["qwen2", "stablelm"]
SERVE = "starcoder2"
#: the layouts that occur only at a model axis of 4 run only there
ONLY_1X4 = ("starcoder2-hd18", "starcoder2-h6")
B, S, MAX_LEN, STEPS, FRAMES = 2, 12, 16, 4, 100
CHUNK_S, CHUNK, CHUNK_MAX_LEN = 16, 8, 24
MANUAL_BATCH = (4, 32)
SERVE_PROMPTS, SERVE_NEW, SERVE_BATCH = (5, 9, 12), 4, 2
WORLD_TIMEOUT_S = 120
#: a model axis of 3 divides neither the padded vocab (256) nor the
#: reduced configs' heads or MLP: each rank holds the whole table, unembed
#: and blocks, and only the cache splits over it (its slots, the key's
#: value or, for None, the teacher case's, a multiple of 3)
ODD_MESH = (1, 3)
ODD = {"starcoder2": MAX_LEN + 2, "paligemma": None}


def _mname(m):
    return f"{m[0]}x{m[1]}"


def _meshes(key):
    return [(1, 4)] if key in ONLY_1X4 else MESHES


#: (case key, mesh) of the teacher-forced cases: each config of TEACHER at
#: its meshes, then the chunked prefill of CHUNKED
TEACHER_CASES = [(k, m) for k in TEACHER for m in _meshes(k)] + [
    (f"chunk_{k}", m) for k in CHUNKED for m in MESHES]


# ---------------------------------------------------------------------------
# without a world: rules, specs, axes


def _flat(tree, prefix=()):
    """{path: leaf} of a nested-dict / NamedTuple tree whose leaves are
    axes tuples (or shapes)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if tree is None:
        return {prefix: None}
    if hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree)}


@functools.lru_cache(maxsize=None)
def _ref_abstract(name):
    specs, axes = jsteps.abstract_params(jfactory.build_model(jget(name)))
    shapes = jax.tree.map(lambda s: tuple(s.shape), specs)
    return _flat(axes), {k: v for k, v in _flat(shapes).items()}


def _fake_jax_mesh(shape):
    return types.SimpleNamespace(axis_names=AXES,
                                 devices=np.empty(shape, dtype=object))


@pytest.mark.parametrize("mesh", SPEC_MESHES, ids=_mname)
@pytest.mark.parametrize("name", jlist())
def test_specs_match_reference(name, mesh):
    """Every leaf's spec by ``rules_for`` (the divisibility guard on its
    whole shape) equals the reference's ``PartitionSpec``; the rules are
    built from the axis sizes alone; ``replicated_rules`` and
    ``batch_spec`` too."""
    want_axes, shapes = _ref_abstract(name)
    jrules = jsteps.rules_for(jget(name), _fake_jax_mesh(mesh))
    trules = tsteps.rules_for(tget(name), dict(zip(AXES, mesh)))
    assert trules.rules == jrules.rules
    sizes = dict(zip(AXES, mesh))
    assert tsharding.replicated_rules(sizes).rules == \
        jsharding.replicated_rules(_fake_jax_mesh(mesh)).rules
    assert tsharding.batch_spec(trules, 2) == tuple(
        jsharding.batch_spec(jrules, 2))
    for path, ax in want_axes.items():
        assert trules.spec(ax, shapes[path]) == tuple(
            jrules.spec(ax, shapes[path])), path


@pytest.mark.parametrize("name", jlist())
def test_param_axes_match_reference(name):
    want, _ = _ref_abstract(name)
    assert _flat(tfactory.build_model(tget(name)).param_axes()) == want


@pytest.mark.parametrize("name", jlist())
def test_state_and_batch_axes_match_reference(name):
    jmodel = jfactory.build_model(jget(name))
    tmodel = tfactory.build_model(tget(name))
    window = jget(name).hybrid.window if jget(name).hybrid else 0
    max_len = max(64, window)
    want = jfactory.state_logical_axes(
        jmodel, jmodel.decode_state_specs(4, max_len))
    got = tfactory.state_logical_axes(
        tmodel, tmodel.decode_state_specs(4, max_len))
    assert _flat(got) == _flat(want)
    for shape in JSHAPES:
        assert tfactory.batch_logical_axes(tget(name), TSHAPES[shape]) == \
            jfactory.batch_logical_axes(jget(name), JSHAPES[shape])
        for mesh in SPEC_MESHES:
            assert tsteps.effective_microbatches(
                tget(name), TSHAPES[shape], dict(zip(AXES, mesh))) == \
                jsteps.effective_microbatches(
                    jget(name), JSHAPES[shape], _fake_jax_mesh(mesh))


class _RankOf:
    """Where rank ``rank`` of a ``(data, model)`` mesh sits, without a
    world: what ``local_shard`` reads of a ``launch/mesh.Mesh``."""
    index = tmesh.Mesh.index

    def __init__(self, shape, rank):
        self.axis_names = AXES
        self.shape = dict(zip(AXES, shape))
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(
            rank, shape))))


class _LoneRank(_RankOf):
    """Rank 0 of a ``(data, model)`` mesh with no world: its collectives
    keep each rank's shapes (a sum returns its input, a gather repeats it,
    an exchange returns what it sends, a block is rank 0's), so a call
    returns rank 0's blocks but not their values."""
    calls = 0

    def __init__(self, shape):
        super().__init__(shape, 0)

    def all_reduce_sum(self, x, axis=None):
        return x

    all_reduce_max = all_reduce_sum

    def sum_grad(self, x, axis):
        return x

    def all_gather(self, x, axis, grad="slice"):
        return torch.stack([x] * self.shape[axis])

    def exchange(self, x, axis, send, recv):
        return x

    def take_block(self, x, axis, dim):
        return x.narrow(dim, 0, x.shape[dim] // self.shape[axis])


@pytest.mark.parametrize(
    "family", ["hybrid", "ssm"])
@pytest.mark.parametrize(
    "entry", ["prefill", "decode", "logits", "decode_state_init"])
def test_unsharded_families_refuse_a_mesh(family, entry):
    """hybrid and ssm on a model axis of 4 run (the name is historical:
    they refused a mesh until ROADMAP A10d): each entry on rank 0 of a (1,
    4) mesh (:class:`_LoneRank`) returns rank 0's blocks, the ssm's and
    RG-LRU's states a quarter of their channels (``"inner"``), the hybrid's
    ring cache whole on its sequence and heads, the logits whole over the
    vocab.  Their values on a mesh: ``tests/test_torch_recurrent_mesh.py``."""
    arch = {"hybrid": "recurrentgemma-2b", "ssm": "falcon-mamba-7b"}[family]
    cfg = dataclasses.replace(tget(arch).reduced(), compute_dtype="float32")
    model = tfactory.build_model(cfg)
    rules = tsteps.rules_for(cfg, _LoneRank((1, 4)))
    params = model.shard_params(model.init(torch.Generator().manual_seed(0),
                                           "cpu"), rules)
    tok = torch.zeros((2, 20), dtype=torch.long)
    state = model.decode_state_init(2, 16, device="cpu", rules=rules)
    V = tlayers.pad_vocab(cfg.vocab)
    with torch.inference_mode():
        if entry == "prefill":
            lg, state = model.prefill(params, {"tokens": tok}, max_len=16,
                                      rules=rules)
            assert lg.shape == (2, V)
        elif entry == "decode":
            lg, state = model.decode(params, tok[:, :1], state,
                                     mesh=rules.mesh, rules=rules)
            assert lg.shape == (2, V)
        elif entry == "logits":
            lg, _ = model.logits(params, {"tokens": tok}, rules=rules)
            assert lg.shape == (2, 20, V)
            return
    specs = model.decode_state_specs(2, 16)
    axes = tfactory.state_logical_axes(model, specs)
    n = 0
    for part in ("kv", "ssm", "lru"):
        if getattr(specs, part) is None:
            assert getattr(state, part) is None
            continue
        for leaf, (shape, _), ax in zip(getattr(state, part),
                                        getattr(specs, part),
                                        getattr(axes, part)):
            want = tuple(d // 4 if a == "inner" else d
                         for d, a in zip(shape, ax))
            assert tuple(leaf.shape) == want, (part, ax)
            n += "inner" in ax
    assert n == 2


def test_disagreeing_ranks_raise():
    """``engine.agreed``: a rank whose tokens differ from another's (here
    a mesh whose max over the ranks is not this rank's) raises; agreeing
    tokens pass through."""
    tok = torch.tensor([[3], [7]])
    same = types.SimpleNamespace(rank=0,
                                 all_reduce_max=lambda x, axis=None: x)
    assert tengine.agreed(tok, same) is tok
    other = types.SimpleNamespace(rank=0,
                                  all_reduce_max=lambda x, axis=None: x + 1)
    with pytest.raises(RuntimeError, match="disagree"):
        tengine.agreed(tok, other)


# ---------------------------------------------------------------------------
# one reference process and one port world for the cases below


def _configs(key):
    arch, fields = CONFIGS[key]
    jcfg = dataclasses.replace(jget(arch).reduced(),
                               compute_dtype="float32", **fields)
    tcfg = dataclasses.replace(tget(arch).reduced(),
                               compute_dtype="float32", **fields)
    return jcfg, tcfg


def _perturb(tree, rng):
    """Noise on the norms and QKV biases (inits of ones and zeros)."""
    if isinstance(tree, dict):
        return {k: (_perturb(v, rng) if isinstance(v, dict) else
                    (v + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
                    if k in ("bq", "bk", "bv", "bias") else
                    (v * rng.uniform(0.5, 1.5, v.shape)).astype(v.dtype)
                    if k == "scale" else v)
                for k, v in tree.items()}
    return tree


def _weights(key):
    """Seeded weights as numpy (drawn by the port's ``init``, the
    reference's scales and layouts; norms and biases perturbed)."""
    _, tcfg = _configs(key)
    params = tfactory.build_model(tcfg).init(
        torch.Generator().manual_seed(len(key)), "cpu")

    def arrays(tree):
        return {k: arrays(v) if isinstance(v, dict) else v.float().numpy()
                for k, v in tree.items()}
    return _perturb(arrays(params), np.random.default_rng(len(key)))


def _save_tree(path, tree):
    np.savez(path, **{"/".join(k): v for k, v in _flat_arrays(tree)})


def _flat_arrays(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_arrays(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _inputs(key):
    """The teacher case's inputs: tokens [B, S], the extras, 4 rows of
    decode tokens, the cache length."""
    jcfg, _ = _configs(key)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab, (B, S))
    steps = rng.integers(0, jcfg.vocab, (STEPS, B))
    extras, max_len = None, MAX_LEN
    if jcfg.family == "vlm":
        extras = {"image_embeds": (0.1 * rng.normal(
            size=(B, jcfg.num_image_tokens, jcfg.d_model))).astype(
                np.float32)}
        max_len += jcfg.num_image_tokens
    elif jcfg.family == "encdec":
        extras = {"frames": (0.1 * rng.normal(
            size=(B, FRAMES, jcfg.d_model))).astype(np.float32)}
    return tokens, extras, steps, max_len


def _chunk_inputs(key):
    jcfg, _ = _configs(key)
    rng = np.random.default_rng(8)
    return (rng.integers(0, jcfg.vocab, (B, CHUNK_S)),
            rng.integers(0, jcfg.vocab, (STEPS, B)))


def _manual_tokens(key):
    jcfg, _ = _configs(key)
    return np.random.default_rng(0).integers(0, jcfg.vocab, MANUAL_BATCH)


def _serve_prompts():
    jcfg, _ = _configs(SERVE)
    rng = np.random.default_rng(9)
    return [rng.integers(0, jcfg.vocab, n).astype(np.int32)
            for n in SERVE_PROMPTS]


_REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs.base import get_config
    from repro.launch.mesh import compat_make_mesh, set_mesh
    from repro.launch.steps import rules_for
    from repro.models import transformer as tfm
    from repro.models.factory import build_model
    from repro.serve.engine import ContinuousBatcher, Request

    spec = json.loads(open(sys.argv[1]).read())
    where = sys.argv[2]           # "local" or a mesh "DxM"
    out = {}

    def tree(path):
        t = {}
        for k, v in np.load(path).items():
            node = t
            *head, last = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = jnp.asarray(v)
        return t

    def config(key):
        arch, fields = spec["configs"][key]
        return dataclasses.replace(get_config(arch).reduced(),
                                   compute_dtype="float32", **fields)

    def batch_of(d):
        b = {"tokens": jnp.asarray(np.asarray(d["tokens"]), jnp.int32)}
        for k, v in (d.get("extras") or {}).items():
            b[k] = jnp.asarray(np.asarray(v, np.float32))
        return b

    def teacher(model, p, d, rules=None, mesh=None):
        b = batch_of(d)
        chunk = d.get("chunk")
        if chunk:
            pf = lambda p, b: tfm.prefill(p, model.cfg, b["tokens"],
                                          max_len=d["max_len"], rules=rules,
                                          chunk=chunk)
        else:
            pf = lambda p, b: model.prefill(p, b, max_len=d["max_len"],
                                            rules=rules)
        lg, st = jax.jit(pf)(p, b)
        dec = jax.jit(lambda p, t, s: model.decode(p, t, s, mesh=mesh,
                                                   rules=rules))
        rows = []
        for r in d["steps"]:
            l, st = dec(p, jnp.asarray(np.asarray(r)[:, None], jnp.int32), st)
            rows.append(np.asarray(l))
        return np.asarray(lg), np.stack(rows)

    mesh = None
    if where != "local":
        mesh = compat_make_mesh(tuple(int(x) for x in where.split("x")),
                                ("data", "model"))
    for case in spec["teacher"]:
        if where not in case["meshes"] + ["local"]:
            continue
        key = case["key"]
        model = build_model(config(key))
        p = tree(spec["weights"][key])
        pre = ("chunk_" if case.get("chunk") else "") + key
        if mesh is None:
            lg, dec = teacher(model, p, case)
        else:
            with set_mesh(mesh):
                lg, dec = teacher(model, p, case, rules_for(model.cfg, mesh),
                                  mesh)
        out[f"{pre}_{where}_prefill"], out[f"{pre}_{where}_decode"] = lg, dec

    for case in spec["manual"]:
        key = case["key"]
        model = build_model(config(key))
        p = tree(spec["weights"][key])
        b = batch_of(case)
        if mesh is None:
            got = model.logits(p, b, remat=False)[0]
        else:
            rules = rules_for(model.cfg, mesh)
            rules.rules["manual_tp"] = True
            with set_mesh(mesh):
                got = jax.jit(lambda p, b: model.logits(
                    p, b, rules=rules, remat=False)[0])(p, b)
        out[f"manual_{key}_{where}"] = np.asarray(got)

    if mesh is None:
        s = spec["serve"]
        model = build_model(config(s["key"]))
        p = tree(spec["weights"][s["key"]])
        bt = ContinuousBatcher(model, p, s["batch"], s["max_len"])
        for rid, pr in enumerate(s["prompts"]):
            bt.submit(Request(rid=rid, prompt=np.asarray(pr, np.int32),
                              max_new_tokens=s["new"]))
        got = bt.run()
        out["serve_tokens"] = np.asarray([got[r] for r in range(len(got))])
    else:
        model = build_model(config(spec["indices"]))
        _, axes = model.init(jax.random.PRNGKey(0))
        p = tree(spec["weights"][spec["indices"]])
        rules = rules_for(model.cfg, mesh)
        for path, leaf in jax.tree_util.tree_leaves_with_path(p):
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


def _case(weights, key, m, **parts):
    arch, fields = CONFIGS[key]
    return {"arch": arch, "reduced": True, "mesh": m,
            "config": {"compute_dtype": "float32", **fields},
            "arrays": weights[key], **parts}


def _port_cases(weights):
    cases = []
    case = functools.partial(_case, weights)
    for key, m in TEACHER_CASES:
        if key.startswith("chunk_"):
            key = key.removeprefix("chunk_")
            tok, steps = _chunk_inputs(key)
            teacher = {"tokens": tok, "steps": steps,
                       "max_len": CHUNK_MAX_LEN, "chunk": CHUNK}
        else:
            tok, extras, steps, max_len = _inputs(key)
            teacher = {"tokens": tok, "extras": extras, "steps": steps,
                       "max_len": max_len}
        cases.append(case(key, m, teacher=teacher))
    cases += [case(key, m, overrides={"manual_tp": True},
                   logits={"tokens": _manual_tokens(key)})
              for key in MANUAL for m in MESHES]
    cases += [case(SERVE, m, serve={"prompts": _serve_prompts(),
                                    "batch": SERVE_BATCH,
                                    "max_len": MAX_LEN, "new": SERVE_NEW})
              for m in MESHES]
    return cases


def _case_keys():
    keys = [f"{k}_{_mname(m)}" for k, m in TEACHER_CASES]
    keys += [f"manual_{k}_{_mname(m)}" for k in MANUAL for m in MESHES]
    keys += [f"serve_{_mname(m)}" for m in MESHES]
    return keys


def _ref_spec(tmp, weights):
    teacher = []
    for key in TEACHER:
        tok, extras, steps, max_len = _inputs(key)
        teacher.append({"key": key, "tokens": tok.tolist(),
                        "extras": None if extras is None else
                        {k: v.tolist() for k, v in extras.items()},
                        "steps": steps.tolist(), "max_len": max_len,
                        "meshes": [_mname(m) for m in _meshes(key)]})
    for key in CHUNKED:
        tok, steps = _chunk_inputs(key)
        teacher.append({"key": key, "tokens": tok.tolist(),
                        "steps": steps.tolist(), "max_len": CHUNK_MAX_LEN,
                        "chunk": CHUNK, "meshes": [_mname(m) for m in MESHES]})
    paths = {}
    for key, tree in weights.items():
        paths[key] = str(tmp / f"w_{key}.npz")
        _save_tree(paths[key], tree)
    return {"configs": CONFIGS, "meshes": MESHES, "weights": paths,
            "teacher": teacher,
            "manual": [{"key": k, "tokens": _manual_tokens(k).tolist()}
                       for k in MANUAL],
            "serve": {"key": SERVE, "prompts": [p.tolist() for p in
                                                _serve_prompts()],
                      "batch": SERVE_BATCH, "max_len": MAX_LEN,
                      "new": SERVE_NEW},
            "indices": SERVE}


@pytest.fixture(scope="module")
def weights():
    return {key: _weights(key) for key in CONFIGS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, weights):
    """(reference npz, the port's per-rank results by case key): the
    reference process runs while the port's world does."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    (tmp / "spec.json").write_text(json.dumps(_ref_spec(tmp, weights)))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    parts = ["local"] + [_mname(m) for m in MESHES]
    refs = [subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp / "spec.json"), part,
         str(tmp / f"ref_{part}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for part in parts]
    try:
        per_rank = tmesh.spawn(launcher.run_lm_cases, 4, "gloo",
                               args=(_port_cases(weights), "cpu"),
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
    port = {k: [rank[i] for rank in per_rank]
            for i, k in enumerate(_case_keys())}
    return want, port


def _close(got, want, tied):
    """Within 1e-5; with a tied embedding ``atol`` scaled by the logits'
    ``|max| / 3.5`` (rows of N(0, 1) make them ~10 times the untied's)."""
    atol = F32 * (max(1.0, float(np.abs(want).max()) / 3.5) if tied else 1)
    np.testing.assert_allclose(got, want, rtol=F32, atol=atol)


def _bits_equal(results, part):
    first = results[0][part]
    for r in results[1:]:
        for k in ("prefill", "decode") if part == "teacher" else (None,):
            a = r[part] if k is None else r[part][k]
            b = first if k is None else first[k]
            assert np.array_equal(a, b), (part, k)


@pytest.mark.parametrize("key,mesh", TEACHER_CASES,
                         ids=[f"{k}-{_mname(m)}" for k, m in TEACHER_CASES])
def test_prefill_and_decode_match_reference(runs, key, mesh):
    """The sharded prefill's last logits and 4 teacher-forced decode steps'
    logits, every row of the batch: against the reference's sharded run
    and its unsharded one; every rank the same bits."""
    ref, port = runs
    results = port[f"{key}_{_mname(mesh)}"]
    _bits_equal(results, "teacher")
    got = results[0]["teacher"]
    jcfg, _ = _configs(key.removeprefix("chunk_"))
    for where in (_mname(mesh), "local"):
        _close(got["prefill"], ref[f"{key}_{where}_prefill"],
               jcfg.tie_embeddings)
        _close(got["decode"], ref[f"{key}_{where}_decode"],
               jcfg.tie_embeddings)
    if _mname(mesh) == "1x4" and not jcfg.n_enc_layers:
        # the embed's sum and the unembed's gather; a layer: the gather of
        # the partial softmaxes, and where the block is tensor parallel the
        # q/k/v gather and the output projection's sum, and the MLP's sum
        _, tcfg = _configs(key.removeprefix("chunk_"))
        rules = tsteps.rules_for(tcfg, dict(zip(AXES, mesh)))
        layer = 1 + 2 * manual_tp.attn_eligible(tcfg, rules) + \
            manual_tp.mlp_eligible(tcfg, rules)
        assert got["collectives_per_decode_step"] == \
            [2 + layer * jcfg.n_layers] * STEPS


@pytest.mark.parametrize("mesh", MESHES, ids=_mname)
@pytest.mark.parametrize("key", MANUAL)
def test_manual_tp_logits_match_reference(runs, key, mesh):
    """``Model.logits`` with ``rules`` and ``manual_tp`` against the
    reference's manual-TP logits and its unsharded ones."""
    ref, port = runs
    results = port[f"manual_{key}_{_mname(mesh)}"]
    _bits_equal(results, "logits")
    got = results[0]["logits"]
    assert got.shape == MANUAL_BATCH + (256,)
    for where in (_mname(mesh), "local"):
        _close(got, ref[f"manual_{key}_{where}"], False)


@pytest.mark.parametrize("mesh", MESHES, ids=_mname)
def test_batcher_on_a_mesh_matches_reference(runs, mesh):
    """``ContinuousBatcher(mesh=, rules=)``: every rank the same tokens,
    the reference's unsharded batcher's."""
    ref, port = runs
    results = port[f"serve_{_mname(mesh)}"]
    toks = [r["serve"]["tokens"] for r in results]
    assert all(t == toks[0] for t in toks[1:])
    want = ref["serve_tokens"]
    assert [toks[0][i] for i in range(len(want))] == want.tolist()


@pytest.mark.parametrize("mesh", MESHES, ids=_mname)
def test_weights_shard_as_reference(runs, weights, mesh):
    """``lm_params_from_arrays(..., rules=)`` gives each rank the block of
    every leaf that the reference's ``NamedSharding`` gives its device."""
    ref, _ = runs
    _, tcfg = _configs(SERVE)
    tree = weights[SERVE]
    for rank in range(4):
        rules = tsteps.rules_for(tcfg, _RankOf(mesh, rank))
        got = dict(_flat_arrays(lm_params_from_arrays(tree, tcfg, "cpu",
                                                      rules)))
        for path, whole in _flat_arrays(tree):
            idx = ref[f"idx_{_mname(mesh)}_{'/'.join(path)}"][rank]
            block = whole[tuple(slice(a, b) for a, b in idx)]
            np.testing.assert_array_equal(got[path].float().numpy(), block,
                                          err_msg=str(path))


@pytest.fixture(scope="module")
def odd_runs(weights):
    """The teacher cases of ``ODD`` on a 3-rank world at ``ODD_MESH``: the
    port's per-rank results by key."""
    cases = []
    for key, max_len in ODD.items():
        tok, extras, steps, teacher_len = _inputs(key)
        cases.append(_case(weights, key, ODD_MESH, teacher={
            "tokens": tok, "extras": extras, "steps": steps,
            "max_len": max_len or teacher_len}))
    per_rank = tmesh.spawn(launcher.run_lm_cases, 3, "gloo",
                           args=(cases, "cpu"), timeout_s=WORLD_TIMEOUT_S)
    return {key: [rank[i] for rank in per_rank]
            for i, key in enumerate(ODD)}


@pytest.mark.parametrize("key", list(ODD))
def test_odd_model_axis_keeps_the_vocab_whole(runs, odd_runs, key):
    """At a model axis that does not divide the padded vocab the spec
    guard leaves the table and the unembed whole: the prefill's and the
    4 teacher-forced decode steps' logits have the reference's unsharded
    shape ``[B, V]`` and values, every rank the same bits, and the embed
    and the unembed make no collective (a decode step: the partitioned
    attention's one gather a layer)."""
    ref, _ = runs
    results = odd_runs[key]
    _bits_equal(results, "teacher")
    got = results[0]["teacher"]
    jcfg, _ = _configs(key)
    for part in ("prefill", "decode"):
        want = ref[f"{key}_local_{part}"]
        assert got[part].shape == want.shape, part
        _close(got[part], want, jcfg.tie_embeddings)
    assert got["collectives_per_decode_step"] == [jcfg.n_layers] * STEPS
