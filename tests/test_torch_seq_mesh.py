"""The context-parallel ``"seq"`` policy on a mesh (``manual_tp``'s ``"seq"``
layout: each rank's block of query rows with every head, the output's rows
gathered over ``"model"``) against the JAX package, on the CPU.

* Without a world: ``manual_tp.attn_layout`` of a step against the
  reference's ``AxisRules.spec`` of its queries, ``("batch", "seq",
  "act_heads", None)``, for every registered config at meshes (1, 2), (1,
  3), (1, 4), (2, 2), (4, 1) and (16, 16) and lengths that the model axis
  divides and that it does not: ``"seq"`` exactly where the spec puts
  ``"model"`` on the sequence, after the reference's manual block (its
  training forward under ``manual_tp`` with eligible heads).
* One 4-rank gloo world of the port (``launch/mesh.spawn`` of
  ``launch/distributed.run_mesh_cases``) and two reference processes with
  four XLA host devices (unsharded, and sharded at (1, 4)), side by side,
  from the same numpy weights in float32 compute, at (1, 4): reduced
  starcoder2-7b with 6 / 2 heads (``h6``: the whole and the chunked
  prefill, chunk 8) and recurrentgemma-2b with 10 / 1 heads (``rg-h10``:
  prompts of 24, longer than the reduced window of 16): the prefill, 4
  teacher-forced decode steps and ``Model.logits`` against the reference's
  sharded and unsharded runs within ``1e-5`` (the hybrid's tied embedding:
  ``atol`` scaled by ``|max| / 3.5``), every rank the same bits; the
  batcher's tokens; the same cases under ``rules_for(..., overrides={"seq":
  None})`` (the ``"full"`` layout) within ``1e-6`` of the largest entry,
  and the collectives of each: one more a prefill's attention layer (the
  gather of the output's rows), the same a decode step; gradient shards
  and two train steps (each from a state both sides share) against
  ``jax.value_and_grad`` at ``tests/test_torch_train_mesh.py``'s
  tolerances.
* One 3-rank world at (1, 3): reduced paligemma-3b (the image prefix) and
  whisper-base (the encoder over 1,536 padded frames and the decoder's
  self-attention ``"seq"``, the cross-attention ``"full"``) against the
  reference's unsharded run.
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
jnp = jax.numpy

from repro.configs.base import get_config as jget  # noqa: E402
from repro.configs.base import list_configs as jlist  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import manual_tp as jtp  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.convert import train_state_from_arrays  # noqa: E402
from repro_torch.launch import distributed as launcher  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import manual_tp  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.models.sharding import shard_by_spec  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.train.checkpoint import _flatten  # noqa: E402
from repro_torch.train.data import batch_for_step  # noqa: E402
from repro_torch.train.optimizer import AdamState, AdamW  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
AXES = ("data", "model")
TABLE_MESHES = [(1, 2), (1, 3), (1, 4), (2, 2), (4, 1), (16, 16)]
#: step lengths of the table: 48 divides every model axis above, 512 all
#: but 3, 100 only 2 and 4, 7 none
TABLE_LENGTHS = (7, 48, 100, 512)
F32, SEQ_VS_FULL = 1e-5, 1e-6
MESH, ODD_MESH = (1, 4), (1, 3)
#: (arch, fields replaced after ``reduced()``)
CONFIGS = {
    "h6": ("starcoder2-7b", {"n_heads": 6, "n_kv_heads": 2}),
    "rg-h10": ("recurrentgemma-2b", {"n_heads": 10, "n_kv_heads": 1}),
    "paligemma": ("paligemma-3b", {}),
    "whisper": ("whisper-base", {}),
}
#: the teacher cases: (batch, prompt, cache slots, chunk or None); every
#: length a multiple of the model axis of their world
TEACHER = {"h6": (2, 16, 16, None), "chunk_h6": (2, 16, 24, 8),
           "rg-h10": (2, 24, 24, None), "paligemma": (2, 10, 24, None),
           "whisper": (2, 12, 18, None)}
WORLD4 = ("h6", "chunk_h6", "rg-h10")
ODD = ("paligemma", "whisper")
STEPS, FRAMES = 4, 100
SERVE_PROMPTS, SERVE_NEW, SERVE_BATCH, SERVE_LEN = (8, 12, 5), 4, 2, 16
#: training: one step at a time from a shared state (the reference's
#: initial state, then the port's unsharded state after one step)
TRAIN_KEYS = ("h6", "rg-h10")
SEQ, BATCH, MICRO, TRAIN_STEPS = 16, 8, 2, 2
LR = ("constant", (1e-3,))
GRAD_REL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)
NU_TOL = dict(rtol=1e-5, atol=1e-9)
WORLD_TIMEOUT_S = 120
FULL = {"seq": None}


def _mname(m):
    return f"{m[0]}x{m[1]}"


def _key(case):
    return case.removeprefix("chunk_")


def _configs(key):
    """(reference cfg, port cfg) of a key, float32 compute."""
    arch, fields = CONFIGS[key]
    return tuple(dataclasses.replace(get(arch).reduced(),
                                     compute_dtype="float32", **fields)
                 for get in (jget, tget))


# ---------------------------------------------------------------------------
# without a world: the layout table


class _RankOf:
    """Rank 0 of a ``(data, model)`` mesh without a world: what
    ``attn_layout`` reads of a ``launch/mesh.Mesh``."""

    def __init__(self, shape):
        self.axis_names = AXES
        self.shape = dict(zip(AXES, shape))
        self.coords = dict.fromkeys(AXES, 0)


def _fake_jax_mesh(shape):
    return types.SimpleNamespace(axis_names=AXES,
                                 devices=np.empty(shape, dtype=object))


def _reference_seq(jcfg, jrules, rows, manual):
    """Whether the reference shards the step's queries on their sequence
    over ``"model"``: not where its manual block runs, else where its q
    spec puts ``"model"`` of more than one device on dim 1."""
    if manual and jrules.rules.get("manual_tp") and \
            jtp.attn_eligible(jcfg, jrules):
        return False
    if jrules._sizes.get("model", 1) == 1:
        return False
    spec = tuple(jrules.spec(("batch", "seq", "act_heads", None),
                             (*rows, jcfg.n_heads, jcfg.head_dim_)))
    entry = spec[1] if len(spec) > 1 else None
    return "model" in (entry if isinstance(entry, tuple) else (entry,))


@pytest.mark.parametrize("overrides", [None, {"seq": "model"}],
                         ids=["rules_for", "seq-override"])
@pytest.mark.parametrize("mesh", TABLE_MESHES, ids=_mname)
@pytest.mark.parametrize("name", jlist())
def test_layout_matches_reference_spec(name, mesh, overrides):
    """``attn_layout(cfg, rules, (B, S), manual)`` is ``"seq"`` exactly
    where the reference's q spec shards the sequence over ``"model"`` (the
    manual block first in its training forward), for every length of
    ``TABLE_LENGTHS`` and batches of 1 and 4; anywhere else the layout of
    the step is the rows-free one (decode's).  Under ``rules_for`` alone
    that is: the rules' ``"seq"`` is ``"model"``, tp > 1 and tp divides
    the length."""
    jcfg, tcfg = jget(name), tget(name)
    jrules = jsteps.rules_for(jcfg, _fake_jax_mesh(mesh), overrides)
    trules = tsteps.rules_for(tcfg, _RankOf(mesh), overrides)
    assert trules.rules == jrules.rules
    tp = mesh[1]
    base = manual_tp.attn_layout(tcfg, trules)
    assert base.kv != "seq"
    n_seq = 0
    for rows in [(b, s) for b in (1, 4) for s in TABLE_LENGTHS]:
        for manual in (False, True):
            want = _reference_seq(jcfg, jrules, rows, manual)
            got = manual_tp.attn_layout(tcfg, trules, rows, manual)
            assert (got.kv == "seq") == want, (rows, manual, got)
            assert got == base or want, (rows, manual)
            n_seq += want
            if overrides is None:
                assert want == (trules.rules["seq"] == "model" and tp > 1
                                and rows[1] % tp == 0)
    if overrides is None and tcfg.n_heads % tp and tp > 1:
        assert n_seq > 0


# ---------------------------------------------------------------------------
# B6's backward at a rank's rows


@pytest.mark.parametrize("window", [None, 12], ids=["causal", "window"])
@pytest.mark.parametrize("rank", range(4))
def test_flash_backward_at_a_ranks_rows(rank, window):
    """``ref.flash_attention_bwd_ref`` (``FlashAttentionFn``'s backward on
    the card) at the shape a rank's ``"seq"`` block gives it: query rows
    ``[i·S/4, (i+1)·S/4)`` at ``q_offset = i·S/4`` against all S keys (the
    keys past the rows masked), against autograd through the plain
    forward and ``jax.grad`` of the reference's ``attend``, float32 within
    1e-5."""
    B, S, H, Hkv, hd = 2, 32, 4, 1, 16
    s, off = S // 4, rank * S // 4
    rng = np.random.default_rng(rank)
    q, k, v, dout = (rng.normal(size=sh).astype(np.float32) for sh in (
        (B, s, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd), (B, s, H, hd)))
    kw = dict(causal=True, window=window, q_offset=off)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = fref.flash_attention_gqa_ref(tq, tk, tv, **kw)
    got = fref.flash_attention_bwd_ref(tq, tk, tv, out,
                                       torch.from_numpy(dout), **kw)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    fref.flash_attention_gqa_ref(*leaves, **kw).backward(
        torch.from_numpy(dout))

    def f(q, k, v):
        o = jattn.attend(q, k, v, off + jnp.arange(s), jnp.arange(S),
                         causal=True, window=window)
        return jnp.sum(o * jnp.asarray(dout))
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    for g, x, w in zip(got, leaves, want):
        np.testing.assert_allclose(g.numpy(), x.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # keys past the rank's last row get no gradient
    assert not got[1][:, off + s:].any() and not got[2][:, off + s:].any()


# ---------------------------------------------------------------------------
# the worlds' inputs


def _weights(key):
    """Seeded weights as numpy (the port's ``init``, the reference's scales
    and layouts; norms and QKV biases perturbed)."""
    _, tcfg = _configs(key)
    params = tbuild(tcfg).init(torch.Generator().manual_seed(len(key)),
                               "cpu")
    rng = np.random.default_rng(len(key))

    def perturb(k, a):
        if k in ("bq", "bk", "bv", "bias"):
            return (a + 0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        if k == "scale":
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(a.dtype)
        return a

    def arrays(tree):
        return {k: arrays(v) if isinstance(v, dict) else
                perturb(k, v.float().numpy()) for k, v in tree.items()}
    return arrays(params)


def _flat_arrays(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_arrays(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _teacher(case):
    """The teacher part of a case: tokens [B, S], 4 rows of decode tokens,
    the extras, the cache slots and the chunk."""
    jcfg, _ = _configs(_key(case))
    b, s, max_len, chunk = TEACHER[case]
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, jcfg.vocab, (b, s)),
           "steps": rng.integers(0, jcfg.vocab, (STEPS, b)),
           "max_len": max_len}
    if chunk:
        out["chunk"] = chunk
    if jcfg.family == "vlm":
        out["extras"] = {"image_embeds": (0.1 * rng.normal(
            size=(b, jcfg.num_image_tokens, jcfg.d_model))).astype(
                np.float32)}
    elif jcfg.family == "encdec":
        out["extras"] = {"frames": (0.1 * rng.normal(
            size=(b, FRAMES, jcfg.d_model))).astype(np.float32)}
    return out


def _serve_prompts():
    jcfg, _ = _configs("h6")
    rng = np.random.default_rng(9)
    return [rng.integers(0, jcfg.vocab, n).astype(np.int32)
            for n in SERVE_PROMPTS]


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


def _case(weights, case, mesh, **parts):
    key = _key(case)
    return {"arch": CONFIGS[key][0], "reduced": True, "mesh": mesh,
            "config": {"compute_dtype": "float32", **CONFIGS[key][1]},
            "arrays": weights[key], **parts}


def _lm_cases(weights):
    """Each WORLD4 teacher case under the rules, then under ``FULL``; the
    whole prefill's cases with ``Model.logits`` too; the batcher."""
    cases = []
    for overrides in ({}, FULL):
        for case in WORLD4:
            t = _teacher(case)
            parts = {"teacher": t}
            if "chunk" not in t:
                parts["logits"] = {"tokens": t["tokens"]}
            cases.append(_case(weights, case, MESH, overrides=overrides,
                               **parts))
    cases.append(_case(weights, "h6", MESH, serve={
        "prompts": _serve_prompts(), "batch": SERVE_BATCH,
        "max_len": SERVE_LEN, "new": SERVE_NEW}))
    return cases


def _lm_keys():
    return [f"{c}{'_full' if o else ''}" for o in ({}, FULL)
            for c in WORLD4] + ["serve"]


def _train_cases(states):
    return [{"arch": CONFIGS[k][0], "reduced": True,
             "config": {"compute_dtype": "float32", **CONFIGS[k][1]},
             "mesh": MESH, "state": states[k][s], "seq": SEQ,
             "batch": BATCH, "microbatches": MICRO, "lr": LR, "steps": 1,
             "first_step": s, "grads": s == 0}
            for k in TRAIN_KEYS for s in range(TRAIN_STEPS)]


_REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
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
        arch, fields = spec["configs"][key]
        return dataclasses.replace(get_config(arch).reduced(),
                                   compute_dtype="float32", **fields)

    def weights(key):
        return unflat(dict(np.load(spec["weights"][key])), "", "/")

    def batch_of(d):
        b = {"tokens": jnp.asarray(np.asarray(d["tokens"]), jnp.int32)}
        for k, v in (d.get("extras") or {}).items():
            b[k] = jnp.asarray(np.asarray(v, np.float32))
        return b

    def teacher(model, p, d, rules=None, mesh=None):
        b = batch_of(d)
        if d.get("chunk"):
            pf = lambda p, b: tfm.prefill(p, model.cfg, b["tokens"],
                                          max_len=d["max_len"], rules=rules,
                                          chunk=d["chunk"])
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
        got = {"prefill": np.asarray(lg), "decode": np.stack(rows)}
        if d.get("logits"):
            got["logits"] = np.asarray(jax.jit(lambda p, b: model.logits(
                p, b, rules=rules, remat=False)[0])(p, b))
        return got

    mesh = None
    if where != "local":
        mesh = compat_make_mesh(tuple(int(x) for x in where.split("x")),
                                ("data", "model"))
    for case in spec["teacher"]:
        if where not in case["meshes"] + ["local"]:
            continue
        model = build_model(config(case["key"]))
        p = weights(case["key"])
        if mesh is None:
            got = teacher(model, p, case)
        else:
            with set_mesh(mesh):
                got = teacher(model, p, case, rules_for(model.cfg, mesh),
                              mesh)
        for part, v in got.items():
            out[f"{case['name']}_{where}_{part}"] = v

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
    np.savez(sys.argv[3], **out)
    print("REF_OK")
""")


def _listed(d):
    return {k: (np.asarray(v).tolist() if k in ("tokens", "steps") else
                {n: a.tolist() for n, a in v.items()} if k == "extras"
                else v) for k, v in d.items()}


def _ref_spec(tmp, weights, states):
    teacher = [{"name": case, "key": _key(case), **_listed(_teacher(case)),
                "logits": case in ("h6", "rg-h10"),
                "meshes": [_mname(MESH)] if case in WORLD4 else []}
               for case in TEACHER]
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
            "serve": {"key": "h6", "prompts": [p.tolist() for p in
                                               _serve_prompts()],
                      "batch": SERVE_BATCH, "max_len": SERVE_LEN,
                      "new": SERVE_NEW},
            "train": {"keys": list(TRAIN_KEYS), "states": states_at,
                      "seq": SEQ, "batch": BATCH, "micro": MICRO,
                      "lr": LR}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference npz, the port's per-rank LM results by case, its
    per-rank train results, its per-rank (1, 3) results by case): the
    reference processes run while the port's worlds do."""
    tmp = tmp_path_factory.mktemp("seq_mesh")
    weights = {key: _weights(key) for key in CONFIGS}
    states = {k: _train_states(k) for k in TRAIN_KEYS}
    (tmp / "spec.json").write_text(json.dumps(_ref_spec(tmp, weights,
                                                        states)))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    parts = ["local", _mname(MESH)]
    refs = [subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp / "spec.json"), part,
         str(tmp / f"ref_{part}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for part in parts]
    try:
        both = tmesh.spawn(launcher.run_mesh_cases, 4, "gloo", args=(
            _lm_cases(weights), _train_cases(states), "cpu"),
            timeout_s=WORLD_TIMEOUT_S)
        odd = tmesh.spawn(launcher.run_lm_cases, 3, "gloo", args=(
            [_case(weights, c, ODD_MESH, teacher=_teacher(c)) for c in ODD],
            "cpu"), timeout_s=WORLD_TIMEOUT_S)
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
    lm = {k: [rank[0][i] for rank in both] for i, k in enumerate(_lm_keys())}
    train = [rank[1] for rank in both]
    odd = {k: [rank[i] for rank in odd] for i, k in enumerate(ODD)}
    return want, lm, train, odd


def _close(got, want, key, rtol=F32):
    """Within ``rtol``; a tied embedding scales ``atol`` by the logits'
    ``|max| / 3.5`` (rows of N(0, 1) make them ~10 times the untied's)."""
    _, tcfg = _configs(key)
    scale = max(1.0, float(np.abs(want).max()) / 3.5) \
        if tcfg.tie_embeddings else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _bits_equal(results, part, keys):
    for r in results[1:]:
        for k in keys:
            assert np.array_equal(r[part][k], results[0][part][k]), (part, k)


def _attn_layers(tcfg) -> int:
    return tcfg.n_layers // 3 if tcfg.family == "hybrid" else tcfg.n_layers


# ---------------------------------------------------------------------------
# serving at (1, 4)


@pytest.mark.parametrize("case", WORLD4)
def test_prefill_and_decode_match_reference(runs, case):
    """Under ``"seq"`` (every attention block of the prefill), the
    prefill's last logits and 4 teacher-forced decode steps' logits, every
    row: against the reference's sharded run and its unsharded one; every
    rank the same bits."""
    ref, lm, _, _ = runs
    results = lm[case]
    _bits_equal(results, "teacher", ("prefill", "decode"))
    got = results[0]["teacher"]
    _, tcfg = _configs(_key(case))
    chunks = TEACHER[case][1] // (TEACHER[case][3] or TEACHER[case][1])
    assert got["prefill_layouts"] == ["seq"] * (_attn_layers(tcfg) * chunks)
    for where in (_mname(MESH), "local"):
        for part in ("prefill", "decode"):
            _close(got[part], ref[f"{case}_{where}_{part}"], _key(case))


@pytest.mark.parametrize("case", ["h6", "rg-h10"])
def test_logits_match_reference(runs, case):
    """``Model.logits(rules=)`` (the training forward, every attention
    block ``"seq"``) against the reference's sharded and unsharded
    logits, every rank the same bits."""
    ref, lm, _, _ = runs
    results = lm[case]
    for r in results[1:]:
        assert np.array_equal(r["logits"], results[0]["logits"])
    _, tcfg = _configs(case)
    assert results[0]["logits_layouts"] == ["seq"] * _attn_layers(tcfg)
    for where in (_mname(MESH), "local"):
        _close(results[0]["logits"], ref[f"{case}_{where}_logits"], case)


def test_batcher_matches_reference(runs):
    """``ContinuousBatcher(mesh=, rules=)`` with prompts of 8 and 12 tokens
    (``"seq"``) and 5 (``"full"``): every rank the same tokens, the
    reference's unsharded batcher's."""
    ref, lm, _, _ = runs
    toks = [r["serve"]["tokens"] for r in lm["serve"]]
    assert all(t == toks[0] for t in toks[1:])
    want = ref["serve_tokens"]
    assert [toks[0][i] for i in range(len(want))] == want.tolist()


@pytest.mark.parametrize("case", WORLD4)
def test_seq_matches_full(runs, case):
    """The same case under ``overrides={"seq": None}`` runs every block
    ``"full"`` (computed whole on every rank): the prefill's, the decode
    steps' and the logits' values within ``1e-6`` of the largest entry of
    the ``"seq"`` run's."""
    _, lm, _, _ = runs
    seq, full = lm[case][0], lm[f"{case}_full"][0]
    assert set(full["teacher"]["prefill_layouts"]) == {"full"}
    for part in ("prefill", "decode"):
        a, b = seq["teacher"][part], full["teacher"][part]
        assert np.abs(a - b).max() <= SEQ_VS_FULL * np.abs(b).max(), part
    if "logits" in seq:
        assert set(full["logits_layouts"]) == {"full"}
        a, b = seq["logits"], full["logits"]
        assert np.abs(a - b).max() <= SEQ_VS_FULL * np.abs(b).max()


@pytest.mark.parametrize("case", WORLD4)
def test_seq_adds_one_collective_per_attention_layer(runs, case):
    """A prefill under ``"seq"`` makes exactly one more collective per
    attention layer and step (the all-gather of the output's rows) than
    under ``"full"``; a decode step makes the same number."""
    _, lm, _, _ = runs
    seq, full = lm[case][0]["teacher"], lm[f"{case}_full"][0]["teacher"]
    _, tcfg = _configs(_key(case))
    chunks = TEACHER[case][1] // (TEACHER[case][3] or TEACHER[case][1])
    assert seq["prefill_collectives"] - full["prefill_collectives"] == \
        _attn_layers(tcfg) * chunks
    assert seq["collectives_per_decode_step"] == \
        full["collectives_per_decode_step"]


@pytest.mark.parametrize("case", ODD)
def test_odd_model_axis_runs_seq(runs, case):
    """At (1, 3) (no head count divides it): paligemma's prefill over its
    image prefix and tokens (18 positions) and whisper's encoder (1,536
    padded frames) and decoder self-attention run ``"seq"``, whisper's
    cross-attention ``"full"``; the prefill's and 4 decode steps' logits
    within 1e-5 of the reference's unsharded run, every rank the same
    bits."""
    ref, _, _, odd = runs
    results = odd[case]
    _bits_equal(results, "teacher", ("prefill", "decode"))
    got = results[0]["teacher"]
    _, tcfg = _configs(case)
    n = tcfg.n_layers
    want = ["seq"] * n
    if tcfg.family == "encdec":
        want = ["seq"] * (tcfg.n_enc_layers or n) + ["seq", "full"] * n
    assert got["prefill_layouts"] == want
    for part in ("prefill", "decode"):
        _close(got[part], ref[f"{case}_local_{part}"], case)


# ---------------------------------------------------------------------------
# training at (1, 4)


def _ref_tree(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


class _At(_RankOf):
    """Rank ``rank`` of a mesh without a world, for ``shard_by_spec``."""
    index = tmesh.Mesh.index

    def __init__(self, shape, rank):
        super().__init__(shape)
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(
            rank, shape))))


def _specs(key):
    """``{params leaf path: spec}`` of a config at MESH."""
    _, tcfg = _configs(key)
    model = tbuild(tcfg)
    rules = tsteps.rules_for(tcfg, dict(zip(AXES, MESH)))
    specs = tts.state_shardings(tts.TrainState(
        params=model.param_shapes(), opt=AdamState(None, None, None),
        step=None), model.param_axes(), rules)
    return dict(_flatten(specs.params, specs=True))


def _block(whole, spec, rank):
    return shard_by_spec(torch.from_numpy(np.asarray(whole)), spec,
                         _At(MESH, rank)).numpy()


def _train_result(train, key, step):
    return [r[TRAIN_KEYS.index(key) * TRAIN_STEPS + step] for r in train]


@pytest.mark.parametrize("key", TRAIN_KEYS)
def test_gradient_shards_match_reference(runs, key):
    """Each rank's shard of the first batch's gradients (2 microbatches of
    4 x 16: every attention block ``"seq"``, so every term of each rank's
    covers its query rows only and is summed over ``"model"``) against its
    block of ``jax.grad`` of the reference's ``Model.loss``, within
    ``GRAD_REL`` of the leaf's largest entry."""
    ref, _, train, _ = runs
    want = _ref_tree(ref, f"grads_{key}/")
    specs = _specs(key)
    for rank, res in enumerate(_train_result(train, key, 0)):
        assert set(res["layouts"]) == {"seq"}
        got = res["grads"]
        assert sorted(got) == sorted(want)
        for path, whole in want.items():
            block = _block(whole, specs[path], rank)
            bound = GRAD_REL * float(np.abs(whole).max())
            err = float(np.abs(got[path] - block).max())
            assert err <= bound, (rank, path, err, bound)


@pytest.mark.parametrize("key", TRAIN_KEYS)
def test_two_steps_match_reference(runs, key):
    """Two steps of ``make_train_step(rules=)`` under ``"seq"``, each from
    the state the reference's step starts from: ``loss``, ``ce``, ``aux``
    and the grad norm against the reference's, every rank the same bits;
    each rank's moments within TOL of its blocks of the reference's and its
    params within TOL plus AdamW's first-order slack from the moments'
    differences (``tests/test_torch_train_mesh.py``)."""
    ref, _, train, _ = runs
    specs = _specs(key)
    opt = AdamW()
    lr = getattr(topt, LR[0])(*LR[1])
    pre = {"params": ".params::", "mu": ".opt::.mu::", "nu": ".opt::.nu::"}
    for s in range(TRAIN_STEPS):
        legs = [r["legs"][0] for r in _train_result(train, key, s)]
        assert all(leg["bits"] == legs[0]["bits"] for leg in legs[1:])
        got = [legs[0][k][0] for k in ("loss", "ce", "aux", "grad_norm")]
        np.testing.assert_allclose(got, ref[f"{key}_metrics{s}"], **TOL)
        bc1, bc2 = 1 - opt.b1 ** (s + 1), 1 - opt.b2 ** (s + 1)
        rate = float(lr(s))
        for rank, leg in enumerate(legs):
            st = leg["state"]
            w = {part: {p: _block(v, specs[p], rank) for p, v in
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
