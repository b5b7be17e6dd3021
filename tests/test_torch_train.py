"""The port's training path against the JAX package's.

Every check starts both packages from the same numpy inputs: optimizer
trees drawn with numpy from a seed, parameters from the reference's
``Model.init(PRNGKey(0))`` (carried across with ``lm_params_from_arrays``
or ``train_state_from_arrays``), batches from each package's own
``batch_for_step``, which agree bit for bit.

Tolerances.  The optimizer, the schedules and the compression: 1e-6
relative (the same float32 operations; torch may fuse a multiply-add).
The whole-model loss and gradients (``tests/test_torch_train_grads.py``)
state theirs there.  A train step from a carried state: 1e-5 on the
metrics, the parameters and the moments.
"""
import dataclasses
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.configs.shapes import ShapeConfig as JShape  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train import compress as jcompress  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.data import DataConfig as JData  # noqa: E402
from repro.train.data import batch_for_step as jbatch  # noqa: E402
from repro.train.train_step import init_train_state as jinit  # noqa: E402
from repro.train.train_step import make_train_step as jmake  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig as TShape  # noqa: E402
from repro_torch.convert import train_state_from_arrays  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.train import compress as tcompress  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.data import DataConfig as TData  # noqa: E402
from repro_torch.train.data import batch_for_step as tbatch  # noqa: E402
from repro_torch.train.train_step import make_train_step as tmake  # noqa: E402

REL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 3, 4)}, "e": (40,)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (scale * rng.normal(size=s)).astype(np.float32)
    return draw(shapes)


def _torch(tree, dtype=torch.float32):
    return topt.tree_map(lambda a: torch.tensor(a, dtype=torch.float32)
                         .to(dtype), tree)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


def _assert_trees(t, j, **tol):
    tl, jl = topt.tree_leaves(t), jax.tree.leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(_np(a), _np(b), **(tol or REL))


# ---------------------------------------------------------------------------
# optimizer and schedules


@pytest.mark.parametrize("case", ["f32", "no_clip", "bf16_master",
                                  "small_grads"])
def test_adamw_matches_reference(case, monkeypatch):
    """Three updates of AdamW: params, moments, count and (bf16 params)
    the float32 master weights.  The port's chunks are 7 elements here,
    so leaves split across chunk boundaries."""
    monkeypatch.setattr(topt, "CHUNK", 7)
    kw = {"no_clip": dict(clip_norm=None)}.get(case, {})
    dtype = torch.bfloat16 if case == "bf16_master" else torch.float32
    jdt = jnp.bfloat16 if case == "bf16_master" else jnp.float32
    gscale = 1e-3 if case == "small_grads" else 1.0   # the clip idle
    p_np = _tree(0)
    jo, to = jopt.AdamW(**kw), topt.AdamW(**kw)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    tp = _torch(p_np, dtype)
    js, ts = jo.init(jp), to.init(tp)
    assert (ts.master is None) == (js.master is None)
    for i in range(3):
        g = _tree(10 + i, gscale)
        lr = jnp.float32(1e-2 * (i + 1))
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp, lr)
        ts = to.update(_torch(g), ts, tp, torch.tensor(1e-2 * (i + 1),
                                                       dtype=torch.float32))
    _assert_trees(tp, jp, **(dict(rtol=0, atol=0) if dtype ==
                             torch.bfloat16 else REL))
    _assert_trees(ts.mu, js.mu)
    _assert_trees(ts.nu, js.nu)
    if js.master is not None:
        _assert_trees(ts.master, js.master)
    assert int(ts.count) == int(js.count) == 3


def test_global_norm_and_clip_match_reference():
    tree = _tree(4, 3.0)
    want = jopt.global_norm(jax.tree.map(jnp.asarray, tree))
    got = topt.global_norm(_torch(tree))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    _assert_trees(topt.clip_by_global_norm(_torch(tree), 1.0),
                  jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                           1.0))


STEPS = [0, 1, 4, 9, 10, 11, 37, 99, 100, 150]


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (1e-3, 10, 100)), ("warmup_cosine", (3e-4, 0, 50)),
    ("constant", (2e-3,)), ("rsqrt", (1e-3, 10))])
def test_schedules_match_reference(name, args):
    jf, tf = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for s in STEPS:
        want = float(jf(jnp.int32(s)))
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = tf(step)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, **REL)


# ---------------------------------------------------------------------------
# compression


def test_int8_quantization_matches_reference():
    x = _tree(7, 0.3)["b"]["d"]
    jq, js = jcompress.quantize_int8(jnp.asarray(x))
    tq, ts = tcompress.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(
        tcompress.dequantize_int8(tq, ts).numpy(),
        np.asarray(jcompress.dequantize_int8(jq, js)))


def test_compress_with_error_feedback_matches_reference():
    """Two rounds: the int8 payloads equal, the decompressed gradients and
    the residuals within 1e-6."""
    g = _tree(8)
    jef = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, g))
    tef = topt.tree_map(torch.zeros_like, _torch(g))
    for r in range(2):
        g = _tree(20 + r)
        jd, jef = jcompress.compress_with_error_feedback(
            jax.tree.map(jnp.asarray, g), jef)
        td, tef = tcompress.compress_with_error_feedback(_torch(g), tef)
        _assert_trees(td, jd)
        _assert_trees(tef, jef, rtol=1e-6, atol=1e-6)
    # the payloads themselves, of the last round's inputs
    for tl, jl in zip(topt.tree_leaves(tef), jax.tree.leaves(jef)):
        tq, _ = tcompress.quantize_int8(tl)
        jq, _ = jcompress.quantize_int8(jl)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


# ---------------------------------------------------------------------------
# data

#: normal draws: torch's erfinv against XLA's polynomial, float32 (a few
#: ulps; 5e-6 relative in the tail, where erfinv is steep)
NORMAL_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch,S,B", [("starcoder2-7b", 33, 3),
                                      ("qwen3-moe-30b-a3b", 16, 2),
                                      ("paligemma-3b", 40, 2),
                                      ("whisper-base", 24, 2)])
def test_batch_for_step_matches_reference(arch, S, B):
    """tokens, labels and loss_mask bit for bit at three steps and two
    seeds; the vlm's image embeddings and the encdec's frames (bf16)
    within one bf16 ulp."""
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    for step, seed in itertools.product((0, 7, 1234), (0, 3)):
        j = jbatch(jc, JShape("t", "train", S, B), step, JData(seed=seed))
        t = tbatch(tc, TShape("t", "train", S, B), step, TData(seed=seed),
                   device="cpu")
        assert sorted(j) == sorted(t)
        for k in ("tokens", "labels", "loss_mask"):
            assert t[k].dtype == {"loss_mask": torch.float32}.get(
                k, torch.int32)
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
        for k in ("image_embeds", "frames"):
            if k in j:
                assert t[k].dtype == tc.cdtype
                # one bf16 ulp: 2^-7 relative at the bottom of a binade
                np.testing.assert_allclose(_np(t[k]), _np(j[k]),
                                           rtol=2 ** -7, atol=1e-7)


def test_prng_draws_match_jax():
    """The draws data.py adds to the threefry stream: randint bit for bit
    (narrow, wide and empty ranges), uniform with bounds bit for bit,
    normal within ``NORMAL_TOL``."""
    for seed, (lo, hi) in itertools.product((0, 5), ((16, 33), (0, 1000),
                                                     (-7, 2 ** 20), (5, 5))):
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        np.testing.assert_array_equal(
            prng.randint(tk, (64,), lo, hi).numpy(),
            np.asarray(jax.random.randint(jk, (64,), lo, hi)))
    jk, tk = jax.random.PRNGKey(2), prng.PRNGKey(2)
    np.testing.assert_array_equal(
        prng.uniform(tk, (8, 33), 1e-6, 1.0).numpy(),
        np.asarray(jax.random.uniform(jk, (8, 33), jnp.float32, 1e-6, 1.0)))
    np.testing.assert_allclose(prng.normal(tk, (4096,)).numpy(),
                               np.asarray(jax.random.normal(jk, (4096,))),
                               **NORMAL_TOL)


# ---------------------------------------------------------------------------
# the train step and the CLI


def _carried(jcfg, compression):
    js = jinit(jbuild(jcfg), jax.random.PRNGKey(0), jopt.AdamW(),
               compression=compression)
    arr = lambda t: None if t is None else jax.tree.map(np.asarray, t)  # noqa
    ts = train_state_from_arrays(
        params=arr(js.params), mu=arr(js.opt.mu), nu=arr(js.opt.nu),
        count=arr(js.opt.count), master=arr(js.opt.master), ef=arr(js.ef),
        step=arr(js.step), device="cpu")
    return js, ts


@pytest.mark.parametrize("microbatches,compression", [(2, True), (1, False)])
def test_train_step_matches_reference(microbatches, compression):
    """Two steps of ``make_train_step`` (warmup-cosine lr) from one carried
    state: metrics, parameters, moments, count, step and the
    error-feedback residual within 1e-5."""
    arch = "starcoder2-7b"
    jcfg = dataclasses.replace(jget(arch).reduced(), compute_dtype="float32")
    tcfg = dataclasses.replace(tget(arch).reduced(), compute_dtype="float32")
    js, ts = _carried(jcfg, compression)
    assert ts.params["stack"]["mlp"]["wi"].dtype == torch.float32
    assert int(ts.step) == 0 and ts.opt.master is None
    lr_j, lr_t = (jopt.warmup_cosine(1e-2, 1, 4),
                  topt.warmup_cosine(1e-2, 1, 4))
    jstep = jax.jit(jmake(jbuild(jcfg), jopt.AdamW(), lr_j,
                          microbatches=microbatches, compression=compression))
    tstep = tmake(tbuild(tcfg), topt.AdamW(), lr_t,
                  microbatches=microbatches, compression=compression)
    tol = dict(rtol=1e-5, atol=1e-5)
    for s in range(2):
        jb = jbatch(jcfg, JShape("t", "train", 16, 4), s)
        tb = tbatch(tcfg, TShape("t", "train", 16, 4), s, device="cpu")
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **tol)
    _assert_trees(ts.params, js.params, **tol)
    _assert_trees(ts.opt.mu, js.opt.mu, **tol)
    _assert_trees(ts.opt.nu, js.opt.nu, rtol=1e-5, atol=1e-9)
    if compression:
        _assert_trees(ts.ef, js.ef, **tol)
    assert int(ts.step) == int(js.step) == 2
    assert int(ts.opt.count) == int(js.opt.count) == 2


def test_production_mesh_needs_its_world():
    """``--production-mesh`` asks for the reference's (16, 16) mesh, which
    needs a world of 256 ranks: off one it raises a ``ValueError`` naming
    the world size, as the reference's fails off a pod."""
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        tlaunch.main(["--reduced", "--device", "cpu", "--production-mesh"])


def test_cli_trains_reduced_on_cpu():
    """``launch/train.py --reduced --device cpu``: every loss finite and
    the last below the first, as the reference's smoke train test."""
    lines = []
    args = tlaunch.parse_args(["--reduced", "--device", "cpu", "--steps",
                               "6", "--batch", "2", "--seq", "24", "--lr",
                               "3e-3"])
    state, stats = tlaunch.run(args, tlaunch.config_for(args), log_every=1,
                               log=lines.append)
    losses = [h["loss"] for h in stats.history]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert stats.steps_run == 6 and int(state.step) == 6
    assert lines[0].startswith("[train] starcoder2-7b (reduced, 2 layers)")
