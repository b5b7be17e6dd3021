"""The port's RG-LRU block and hybrid family (recurrentgemma-2b), and both
recurrent families through ``ContinuousBatcher`` and the serving CLI,
against the JAX package's.

The family tests start from the JAX package's ``Model.init(PRNGKey(0))``
weights of the ``reduced()`` config (window 16), carried across with
``convert.lm_params_from_arrays``; the leaves the reference inits to
constants (norm scales, ``conv_b`` and the gates' ``w_a, b_a, w_x, b_x``)
get seeded numpy noise first, so that their order of use is tested too.

Tolerances.  Caches and states: float32 ``rtol=atol=1e-5``; bfloat16
``test_torch_lm.py``'s ``BF16_CACHE`` (``atol=0.05``).  Logits: float32
``rtol=atol=1e-5`` and bfloat16 ``BF16_LOGITS`` (``atol=0.08``), both set
at the dense configs' logits of |max| ~3.5, with the absolute part scaled
by the logits' own range.  The hybrid ties its embedding (rows N(0, 1), no
1/sqrt(d) unembed scale), so its reduced logits reach |max| ~33, and the
same relative rounding moves them ~10x as far: the unembed's float32 sums
differ by up to 1.1e-5 between the two frameworks, and in bfloat16 the
port differs from the reference by 0.22 where the reference's own bf16 run
differs from its float32 run by 0.22 (measured when the tolerances were
set).
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.serve.engine import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

ARCH = "recurrentgemma-2b"
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_LOGITS = dict(rtol=0, atol=0.08)
BF16_CACHE = dict(rtol=0, atol=0.05)
#: |max| of the dense configs' reduced logits, where BF16_LOGITS was set
DENSE_LOGIT_SCALE = 3.5
MAX_LEN = 40


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _logits_tol(want, tol):
    """``tol`` with its ``atol`` scaled by |max| of the logits over the
    dense configs' (see the module docstring)."""
    scale = max(1.0, float(np.abs(_np(want)).max()) / DENSE_LOGIT_SCALE)
    return dict(tol, atol=tol["atol"] * scale)


def _perturb(tree, seed=0):
    """Noise on the leaves the reference inits to constants."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        name = path[-1]
        if name in ("conv_b", "bias", "w_a", "b_a", "w_x", "b_x"):
            return (node + 0.1 * rng.normal(size=node.shape)).astype(
                node.dtype)
        if name == "scale":
            return (node * rng.uniform(0.5, 1.5, node.shape)).astype(
                node.dtype)
        return node
    return walk(tree, ())


@functools.lru_cache(maxsize=None)
def _setup(name, dtype):
    jcfg = dataclasses.replace(jget(name).reduced(), compute_dtype=dtype)
    tcfg = dataclasses.replace(tget(name).reduced(), compute_dtype=dtype)
    params, _ = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tree = _perturb(jax.tree.map(np.asarray, params))
    jm = jbuild(jcfg)
    jfns = (jax.jit(jm.prefill, static_argnames=("max_len",)),
            jax.jit(jm.decode))
    return (jcfg, jax.tree.map(jnp.asarray, tree), jfns, tcfg,
            lm_params_from_arrays(tree, tcfg, device="cpu"), tree)


# ---------------------------------------------------------------------------
# the block


def _block(seed=0):
    cfg = jget(ARCH).reduced()
    p, _ = jrg.init_rglru(jax.random.PRNGKey(seed), cfg, jnp.float32)
    p = _perturb(jax.tree.map(np.asarray, p), seed)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()},
            cfg.d_model)


@pytest.mark.parametrize("S,chunk", [(16, 8), (12, 8), (1100, None),
                                     (2048, None)])
@pytest.mark.parametrize("seeded", [False, True])
def test_apply_rglru_matches_jax(S, chunk, seeded):
    """Both sides of the chunk rule (the default 1024 and a small one),
    with and without a seed state."""
    jp, tp, d = _block()
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, d)).astype(np.float32)
    kw = {} if chunk is None else {"chunk": chunk}
    jst = tst = None
    if seeded:
        conv = rng.normal(size=(2, 3, d)).astype(np.float32)
        h = rng.normal(size=(2, d)).astype(np.float32)
        jst = jrg.LRUState(conv=jnp.asarray(conv), h=jnp.asarray(h))
        tst = trg.LRUState(conv=torch.from_numpy(conv), h=torch.from_numpy(h))
    jy, jn = jrg.apply_rglru(jp, jnp.asarray(x), jst, **kw)
    ty, tn = trg.apply_rglru(tp, torch.from_numpy(x), tst, **kw)
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    for g, w in zip(tn, jn):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


def test_decode_rglru_matches_jax():
    jp, tp, d = _block(1)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 1, d)).astype(np.float32)
    conv = rng.normal(size=(3, 3, d)).astype(np.float32)
    h = rng.normal(size=(3, d)).astype(np.float32)
    jy, jn = jrg.decode_rglru(jp, jnp.asarray(x),
                              jrg.LRUState(jnp.asarray(conv), jnp.asarray(h)))
    ty, tn = trg.decode_rglru(tp, torch.from_numpy(x),
                              trg.LRUState(torch.from_numpy(conv),
                                           torch.from_numpy(h)))
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    for g, w in zip(tn, jn):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


# ---------------------------------------------------------------------------
# the family


def _compare_state(jst, tst, tol):
    np.testing.assert_array_equal(_np(tst.kv.length), _np(jst.kv.length))
    for g, w in (*zip(tst.kv[:2], jst.kv[:2]), *zip(tst.lru, jst.lru)):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **tol)
    assert tst.ssm is None


@pytest.mark.parametrize("S", [10, 16, 21, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype, S):
    """Prefill's last logits, the ring cache, its length and every lru leaf,
    then 6 decode steps (fed the JAX package's greedy tokens).  Prompts
    below, at and past the reduced window of 16, on and off a multiple of
    it: past it the reference's length stays at the window and its decode
    writes slot ``length % window`` with RoPE at ``length`` (ROADMAP C4),
    and so does the port's."""
    jcfg, jp, (jpre, jdec), tcfg, tp, _ = _setup(ARCH, dtype)
    ltol, ctol = ((F32, F32) if dtype == "float32"
                  else (BF16_LOGITS, BF16_CACHE))
    tok = np.random.default_rng(S).integers(0, jcfg.vocab, (2, S))
    jlast, jst = jpre(jp, {"tokens": jnp.asarray(tok)}, max_len=MAX_LEN)
    tm = tbuild(tcfg)
    tlast, tst = tm.prefill(tp, {"tokens": torch.from_numpy(tok)},
                            max_len=MAX_LEN)
    assert tst.kv.k.shape[2] == jcfg.hybrid.window
    assert tst.kv.length.tolist() == [min(S, jcfg.hybrid.window)] * 2
    np.testing.assert_allclose(_np(tlast), _np(jlast),
                               **_logits_tol(jlast, ltol))
    _compare_state(jst, tst, ctol)
    for _ in range(6):
        nxt = np.asarray(jnp.argmax(jlast, -1))[:, None]
        jlast, jst = jdec(jp, jnp.asarray(nxt), jst)
        tlast, tst = tm.decode(tp, torch.tensor(nxt), tst)
        np.testing.assert_allclose(_np(tlast), _np(jlast),
                                   **_logits_tol(jlast, ltol))
    _compare_state(jst, tst, ctol)


def test_decode_needs_a_cache_as_long_as_the_window():
    """ROADMAP C5: with max_len 8 < window 16 the reference prefills but
    its decode fails on a shape mismatch; the port raises a ValueError
    that names both numbers (its prefill, like the reference's, works)."""
    jcfg, jp, (jpre, jdec), tcfg, tp, _ = _setup(ARCH, "float32")
    tok = np.random.default_rng(0).integers(0, jcfg.vocab, (1, 6))
    jlast, jst = jpre(jp, {"tokens": jnp.asarray(tok)}, max_len=8)
    with pytest.raises((ValueError, TypeError)):
        jdec(jp, jnp.zeros((1, 1), jnp.int32), jst)
    tm = tbuild(tcfg)
    tlast, tst = tm.prefill(tp, {"tokens": torch.from_numpy(tok)},
                            max_len=8)
    np.testing.assert_allclose(_np(tlast), _np(jlast),
                               **_logits_tol(jlast, F32))
    with pytest.raises(ValueError, match=r"8 slots.*window 16"):
        tm.decode(tp, torch.zeros((1, 1), dtype=torch.long), tst)
    with pytest.raises(ValueError, match=r"8 slots.*window 16"):
        tm.decode_state_init(2, 8, device="cpu")


def test_storage_dtypes_keep_the_gates_f32():
    """bf16 compute: the RG-LRU's matmul weights and conv in bf16, ``lam``
    and the gates' ``w_a, b_a, w_x, b_x`` float32 and unrounded in the
    stored groups and tail and after ``cast_layer_params``."""
    _, _, _, tcfg, tp, tree = _setup(ARCH, "bfloat16")
    for stack, ref in ((tp["groups"]["rec1"], tree["groups"]["rec1"]),
                       (tp["tail"], tree["tail"])):
        rec = stack["rec"]
        assert rec["in_x"].dtype == rec["out"].dtype == torch.bfloat16
        assert rec["conv_w"].dtype == torch.bfloat16
        for name in ("lam", "w_a", "b_a", "w_x", "b_x"):
            assert rec[name].dtype == torch.float32, name
            np.testing.assert_array_equal(rec[name].numpy(),
                                          ref["rec"][name])
        cast = ttfm.cast_layer_params(ttfm._layer(stack, 0), tcfg.cdtype)
        assert cast["rec"]["lam"].dtype == torch.float32
        assert cast["mlp"]["wi"].dtype == cast["ln2"]["scale"].dtype == \
            torch.bfloat16
    assert tp["groups"]["attn"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["embed"]["embedding"].dtype == torch.float32   # tied


def test_params_carry_across_groups_and_tail():
    """The reduced hybrid (4 layers) is one (rec1, rec2, attn) group and a
    tail of one rec layer; ``lm_params_from_arrays`` and ``Model.init``
    build the reference's tree, the float32 leaves bit for bit."""
    _, _, _, tcfg, tp, tree = _setup(ARCH, "float32")

    def shapes(node):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in node.items()}
    assert sorted(tp) == ["embed", "final_norm", "groups", "tail"]
    assert sorted(tp["groups"]) == ["attn", "rec1", "rec2"]
    assert shapes(tp) == shapes(tree)
    assert shapes(tbuild(tcfg).init(device="cpu")) == shapes(tree)
    assert tp["tail"]["rec"]["in_x"].shape[0] == 1
    np.testing.assert_array_equal(tp["groups"]["rec2"]["rec"]["in_gate"]
                                  .numpy(),
                                  tree["groups"]["rec2"]["rec"]["in_gate"])
    m = tbuild(tcfg)
    assert m.n_attn_layers() == 1
    st = m.decode_state_init(2, MAX_LEN, filled=3, device="cpu")
    assert tuple(st.kv.k.shape) == (1, 2, 16, 1, 16)
    assert tuple(st.lru.h.shape) == (3, 2, 64)
    assert st.kv.length.tolist() == [3, 3] and st.ssm is None


# ---------------------------------------------------------------------------
# serving


@pytest.mark.parametrize("name", ["falcon-mamba-7b", ARCH])
def test_continuous_batching_matches_jax(name):
    """The reference's batcher test (tests/test_serve.py) plus a prompt
    longer than the hybrid's window, through a batch of two: every token
    equals the JAX package's batcher's, in float32 compute."""
    jcfg, jp, _, tcfg, tp, _ = _setup(name, "float32")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jcfg.vocab, T).astype(np.int32)
               for T in (5, 8, 6, 7, 21)]
    jb = JBatcher(jbuild(jcfg), jp, batch_size=2, max_len=48)
    tb = tengine.ContinuousBatcher(tbuild(tcfg), tp, batch_size=2,
                                   max_len=48, device="cpu")
    for b, R in ((jb, JRequest), (tb, tengine.Request)):
        for i, p in enumerate(prompts):
            b.submit(R(rid=i, prompt=p, max_new_tokens=5))
    want, got = jb.run(), tb.run()
    assert got == want
    assert (tb.steps, tb.tokens_out) == (jb.steps, jb.tokens_out)


def test_insert_slot_copies_recurrent_states_in_place():
    m = tbuild(tget(ARCH).reduced())
    st = m.decode_state_init(3, 16, device="cpu")
    ps = m.decode_state_init(1, 16, filled=5, device="cpu")
    for t in (*ps.kv[:2], *ps.lru):
        t.normal_()
    out = tengine.insert_slot(st, ps, 1)
    assert out is st
    for dst, src in (*zip(st.kv[:2], ps.kv[:2]), *zip(st.lru, ps.lru)):
        assert torch.equal(dst[:, 1], src[:, 0])
        assert not dst[:, [0, 2]].any()
    assert st.kv.length.tolist() == [0, 5, 0]
    m = tbuild(tget("falcon-mamba-7b").reduced())
    st = m.decode_state_init(2, 16, device="cpu")
    ps = m.decode_state_init(1, 16, device="cpu")
    ps.ssm.h.normal_()
    tengine.insert_slot(st, ps, 0)
    assert torch.equal(st.ssm.h[:, 0], ps.ssm.h[:, 0])
    assert not st.ssm.h[:, 1].any()


@pytest.mark.parametrize("name", ["falcon-mamba-7b", ARCH])
def test_serve_lm_cli_on_cpu(name, capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", name, "--device", "cpu", "--requests", "3",
                      "--batch", "2", "--max-new", "3", "--max-len", "32"])
    assert sorted(out) == [0, 1, 2] and all(len(t) == 3 for t in out.values())
    assert f"[serve] {name} on cpu" in capsys.readouterr().out
