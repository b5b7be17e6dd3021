"""The port's linear-recurrence scan, Mamba block and ssm family
(falcon-mamba-7b) against the JAX package's.

The family tests start from the JAX package's ``Model.init(PRNGKey(0))``
weights of the ``reduced()`` config, carried across with
``convert.lm_params_from_arrays``; the leaves the reference inits to
constants (norm scales, ``conv_b``, ``dt_bias``, ``D``) get seeded numpy
noise first, so that their order of use is tested too.  Inputs are numpy
from a seed.

Tolerances.  float32: ``rtol=atol=1e-5`` (the reference's
``associative_scan`` and the port's doubling scan sum the same recurrence
in another order).  bfloat16: ``test_torch_lm.py``'s ``BF16_LOGITS``
(``atol=0.08``) on the logits and ``BF16_CACHE`` (``atol=0.05``) on the
states, for the reasons given there.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402

ARCH = "falcon-mamba-7b"
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_LOGITS = dict(rtol=0, atol=0.08)
BF16_CACHE = dict(rtol=0, atol=0.05)
MAX_LEN = 40


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _perturb(tree, seed=0):
    """Noise on the leaves the reference inits to constants."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        name = path[-1]
        if name in ("conv_b", "bias"):
            return (node + 0.1 * rng.normal(size=node.shape)).astype(
                node.dtype)
        if name == "dt_bias":
            return (node + 0.5 * rng.normal(size=node.shape)).astype(
                node.dtype)
        if name in ("scale", "D"):
            return (node * rng.uniform(0.5, 1.5, node.shape)).astype(
                node.dtype)
        return node
    return walk(tree, ())


@functools.lru_cache(maxsize=None)
def _setup(dtype):
    jcfg = dataclasses.replace(jget(ARCH).reduced(), compute_dtype=dtype)
    tcfg = dataclasses.replace(tget(ARCH).reduced(), compute_dtype=dtype)
    params, _ = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tree = _perturb(jax.tree.map(np.asarray, params))
    jm = jbuild(jcfg)
    jfns = (jax.jit(jm.prefill, static_argnames=("max_len",)),
            jax.jit(jm.decode))
    return (jcfg, jax.tree.map(jnp.asarray, tree), jfns, tcfg,
            lm_params_from_arrays(tree, tcfg, device="cpu"), tree)


# ---------------------------------------------------------------------------
# the scan


def _sequential(a, b, h0):
    h = np.zeros_like(b[:, 0]) if h0 is None else h0
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return np.stack(out, 1)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 70), st.integers(0, 2 ** 31 - 1), st.booleans())
def test_linear_scan_equals_sequential_loop(S, seed, seeded):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (2, S, 3)).astype(np.float32)
    b = rng.normal(size=(2, S, 3)).astype(np.float32)
    h0 = rng.normal(size=(2, 3)).astype(np.float32) if seeded else None
    got = tssm.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                           None if h0 is None else torch.from_numpy(h0))
    assert got.shape == (2, S, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _sequential(a, b, h0), **F32)


def test_linear_scan_takes_log2_steps(monkeypatch):
    """The doubling scan issues ceil(log2 S) combine steps, not S."""
    calls = []
    real = torch.addcmul

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(torch, "addcmul", counting)
    tssm.linear_scan(torch.rand(1, 1000, 2), torch.rand(1, 1000, 2))
    assert len(calls) == 10


# ---------------------------------------------------------------------------
# the block


def _block(seed=0):
    cfg = jget(ARCH).reduced()
    p, _ = jssm.init_ssm(jax.random.PRNGKey(seed), cfg, jnp.float32)
    p = _perturb(jax.tree.map(np.asarray, p), seed)
    return (cfg, tget(ARCH).reduced(), {k: jnp.asarray(v) for k, v in
                                        p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


def _state(rng, B, cfg):
    _, din, _ = jssm.dims(cfg)
    return (rng.normal(size=(B, cfg.ssm.conv_width - 1, din)).astype(
        np.float32), rng.normal(size=(B, din, cfg.ssm.state_dim)).astype(
        np.float32))


@pytest.mark.parametrize("S,chunk", [(16, 8), (12, 8), (600, None),
                                     (1024, None)])
@pytest.mark.parametrize("seeded", [False, True])
def test_apply_ssm_matches_jax(S, chunk, seeded):
    """Both sides of the chunk rule (chunked only when S > chunk and S %
    chunk == 0), with and without a seed state."""
    jcfg, tcfg, jp, tp = _block()
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    kw = {} if chunk is None else {"chunk": chunk}
    jst = tst = None
    if seeded:
        conv, h = _state(rng, 2, jcfg)
        jst = jssm.SSMState(conv=jnp.asarray(conv), h=jnp.asarray(h))
        tst = tssm.SSMState(conv=torch.from_numpy(conv),
                            h=torch.from_numpy(h))
    jy, jn = jssm.apply_ssm(jp, jnp.asarray(x), jcfg, jst, **kw)
    ty, tn = tssm.apply_ssm(tp, torch.from_numpy(x), tcfg, tst, **kw)
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    for g, w in zip(tn, jn):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


def test_decode_ssm_matches_jax():
    jcfg, tcfg, jp, tp = _block(1)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
    conv, h = _state(rng, 3, jcfg)
    jy, jn = jssm.decode_ssm(jp, jnp.asarray(x), jcfg,
                             jssm.SSMState(jnp.asarray(conv), jnp.asarray(h)))
    ty, tn = tssm.decode_ssm(tp, torch.from_numpy(x), tcfg,
                             tssm.SSMState(torch.from_numpy(conv),
                                           torch.from_numpy(h)))
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    for g, w in zip(tn, jn):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


def test_softplus_is_exact_above_torch_threshold():
    """jax.nn.softplus has no threshold; ``F.softplus`` returns x above 20."""
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 21.0, 40.0], np.float32)
    got = tssm._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.softplus(x)))


# ---------------------------------------------------------------------------
# the family


def _compare_state(jst, tst, tol):
    assert jst.kv is None and tst.kv is None and tst.lru is None
    for g, w in zip(tst.ssm, jst.ssm):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **tol)


@pytest.mark.parametrize("S", [10, 21])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype, S):
    """Prefill's last logits and every state leaf, then 6 decode steps'
    logits and the state after them (both fed the JAX package's greedy
    tokens)."""
    jcfg, jp, (jpre, jdec), tcfg, tp, _ = _setup(dtype)
    ltol, ctol = ((F32, F32) if dtype == "float32"
                  else (BF16_LOGITS, BF16_CACHE))
    tok = np.random.default_rng(S).integers(0, jcfg.vocab, (2, S))
    jlast, jst = jpre(jp, {"tokens": jnp.asarray(tok)}, max_len=MAX_LEN)
    tm = tbuild(tcfg)
    tlast, tst = tm.prefill(tp, {"tokens": torch.from_numpy(tok)},
                            max_len=MAX_LEN)
    np.testing.assert_allclose(_np(tlast), _np(jlast), **ltol)
    _compare_state(jst, tst, ctol)
    for _ in range(6):
        nxt = np.asarray(jnp.argmax(jlast, -1))[:, None]
        jlast, jst = jdec(jp, jnp.asarray(nxt), jst)
        tlast, tst = tm.decode(tp, torch.tensor(nxt), tst)
        np.testing.assert_allclose(_np(tlast), _np(jlast), **ltol)
    _compare_state(jst, tst, ctol)


def test_prefill_is_never_chunked(monkeypatch):
    """The reference chunks only dense, moe and vlm prompts; a long ssm
    prompt takes the whole prefill (its scan chunks by itself)."""
    taken = []
    monkeypatch.setattr(ttfm, "_prefill_chunked",
                        lambda *a, **k: taken.append("chunked"))
    monkeypatch.setattr(ttfm, "_prefill_whole",
                        lambda *a, **k: taken.append("whole"))
    for name in (ARCH, "recurrentgemma-2b"):
        ttfm.prefill(None, tget(name).reduced(),
                     torch.zeros((1, 16), dtype=torch.long), max_len=24,
                     chunk=8)
    assert taken == ["whole", "whole"]


def test_storage_dtypes_keep_the_recurrence_leaves_f32():
    """bf16 compute: matmul weights in bf16, the ``_KEEP_F32`` leaves in
    float32 (not rounded: the decays are the reference's), ``x_proj`` and
    ``dt_proj`` in float32 (the reference's decode reads them uncast);
    ``cast_layer_params`` casts the latter two, never the former."""
    _, jp, _, tcfg, tp, tree = _setup("bfloat16")
    ssm = tp["stack"]["ssm"]
    assert ssm["in_proj"].dtype == ssm["out_proj"].dtype == torch.bfloat16
    assert ssm["conv_w"].dtype == torch.bfloat16
    for name in ("A_log", "D", "dt_bias", "x_proj", "dt_proj"):
        assert ssm[name].dtype == torch.float32, name
        np.testing.assert_array_equal(ssm[name].numpy(),
                                      tree["stack"]["ssm"][name])
    assert ttfm.storage_dtype(("stack", "ssm", "A_log"), tcfg) == \
        torch.float32
    cast = ttfm.cast_layer_params(ttfm._layer(tp["stack"], 0), tcfg.cdtype)
    assert cast["ssm"]["A_log"].dtype == cast["ssm"]["D"].dtype == \
        cast["ssm"]["dt_bias"].dtype == torch.float32
    assert cast["ssm"]["x_proj"].dtype == torch.bfloat16
    assert cast["ln1"]["scale"].dtype == torch.bfloat16
    want = jtfm.cast_layer_params(jax.tree.map(lambda t: t[0], jp["stack"]),
                                  jnp.bfloat16)
    for k, v in cast["ssm"].items():
        assert str(v.dtype).split(".")[-1] == str(want["ssm"][k].dtype), k


def test_params_carry_across_with_the_reference_tree():
    """``lm_params_from_arrays`` keeps the reference's keys and shapes, the
    float32 leaves bit for bit; ``Model.init`` on the CPU builds the same
    tree."""
    _, jp, _, tcfg, tp, tree = _setup("float32")

    def shapes(node):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in node.items()}
    assert shapes(tp) == shapes(tree)
    assert shapes(tbuild(tcfg).init(device="cpu")) == shapes(tree)
    np.testing.assert_array_equal(tp["stack"]["ssm"]["A_log"].numpy(),
                                  tree["stack"]["ssm"]["A_log"])


def test_decode_state_has_no_cache():
    m = tbuild(tget(ARCH).reduced())
    assert m.n_attn_layers() == 0
    st = m.decode_state_init(3, 16, device="cpu")
    assert st.kv is None and st.lru is None
    assert tuple(st.ssm.conv.shape) == (2, 3, 3, 128)
    assert tuple(st.ssm.h.shape) == (2, 3, 128, 4)
    assert st.ssm.h.dtype == torch.float32
