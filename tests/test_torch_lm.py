"""The port's LM serving path against the JAX package's.

Each dense config's ``reduced()`` variant starts from the JAX package's
``Model.init(PRNGKey(0))`` weights, carried across with
``convert.lm_params_from_arrays``; the QKV biases and the norms' scales and
biases (zeros and ones at init) are perturbed with seeded numpy noise first,
so that their order of use is tested too.  Prompts are numpy from a seed.
On the CPU the port's attention runs the flash kernel's plain version.

Tolerances.  ``compute_dtype="float32"``: ``rtol=atol=1e-5`` on logits and
caches (the same float32 products and sums, in another order).  bfloat16:
the two frameworks round the bf16 products, GELU and RoPE at other points,
and a one-ulp difference of a bf16 activation (2^-8 relative) moves the
float32 logits (|max| ~3.5) by a few hundredths after two layers: 0.037 at
most over the four configs when the tolerance was set, so ``atol=0.08`` on
the logits; the caches differ by one or two bf16 ulps (0.023 at most), so
``atol=0.05`` there.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.serve.engine import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

DENSE = ["starcoder2-7b", "qwen2-72b", "stablelm-12b", "mistral-large-123b"]
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_LOGITS = dict(rtol=0, atol=0.08)
BF16_CACHE = dict(rtol=0, atol=0.05)
MAX_LEN = 24


def _perturb(tree, seed=0):
    """Noise on the norms and QKV biases (the reference inits them to ones
    and zeros)."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        name = path[-1]
        if name in ("bq", "bk", "bv", "bias"):
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
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            lm_params_from_arrays(tree, tcfg, device="cpu"))


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def _compare_state(jst, tst, tol):
    np.testing.assert_array_equal(_np(tst.kv.length), _np(jst.kv.length))
    np.testing.assert_allclose(_np(tst.kv.k), _np(jst.kv.k), **tol)
    np.testing.assert_allclose(_np(tst.kv.v), _np(jst.kv.v), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_match_jax(name, dtype):
    """Prefill's last logits and KV cache, then 4 decode steps' logits and
    the cache after them (both fed the JAX package's greedy tokens)."""
    jcfg, jp, tcfg, tp = _setup(name, dtype)
    ltol, ctol = ((F32, F32) if dtype == "float32"
                  else (BF16_LOGITS, BF16_CACHE))
    tok = _tokens(1, 2, 12, jcfg.vocab)
    jlast, jst = jbuild(jcfg).prefill(jp, {"tokens": jnp.asarray(tok)},
                                      max_len=MAX_LEN)
    tm = tbuild(tcfg)
    tlast, tst = tm.prefill(tp, {"tokens": torch.from_numpy(tok)},
                            max_len=MAX_LEN)
    assert tlast.dtype == torch.float32
    np.testing.assert_allclose(_np(tlast), _np(jlast), **ltol)
    _compare_state(jst, tst, ctol)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jlast, -1))[:, None]
        jlast, jst = jbuild(jcfg).decode(jp, jnp.asarray(nxt), jst)
        tlast, tst = tm.decode(tp, torch.tensor(nxt), tst)
        np.testing.assert_allclose(_np(tlast), _np(jlast), **ltol)
    _compare_state(jst, tst, ctol)


@pytest.mark.parametrize("name", DENSE)
def test_chunked_prefill_matches_jax(name):
    """``prefill(..., chunk=8)`` on a 16-token prompt takes the chunked
    branch in both packages: the second chunk attends with ``q_offset=8``
    against a prefix view of the cache."""
    jcfg, jp, tcfg, tp = _setup(name, "float32")
    tok = _tokens(2, 1, 16, jcfg.vocab)
    jlast, jst = jtfm.prefill(jp, jcfg, jnp.asarray(tok), max_len=MAX_LEN,
                              chunk=8)
    tlast, tst = ttfm.prefill(tp, tcfg, torch.from_numpy(tok),
                              max_len=MAX_LEN, chunk=8)
    np.testing.assert_allclose(_np(tlast), _np(jlast), **F32)
    _compare_state(jst, tst, F32)


def test_prefill_branches(monkeypatch):
    """Chunked only when S > chunk, S % chunk == 0 and the cache holds S;
    a prompt of exactly ``chunk`` tokens takes the whole branch."""
    taken = []
    monkeypatch.setattr(ttfm, "_prefill_chunked",
                        lambda *a, **k: taken.append("chunked"))
    monkeypatch.setattr(ttfm, "_prefill_whole",
                        lambda *a, **k: taken.append("whole"))
    cfg = tget("starcoder2-7b").reduced()
    for S, max_len in ((16, 24), (8, 24), (12, 24), (16, 12), (16, None)):
        ttfm.prefill(None, cfg, torch.zeros((1, S), dtype=torch.long),
                     max_len=max_len, chunk=8)
    assert taken == ["chunked", "whole", "whole", "whole", "chunked"]


def test_continuous_batching_matches_jax():
    """Three requests through a batch of two: the second slot is refilled
    by a batch-1 prefill inserted mid-run; every token equals the JAX
    package's batcher's, in float32 compute."""
    jcfg, jp, tcfg, tp = _setup("starcoder2-7b", "float32")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab, T).astype(np.int32)
               for T in (5, 9, 7)]
    news = (5, 3, 4)
    jb = JBatcher(jbuild(jcfg), jp, batch_size=2, max_len=MAX_LEN)
    tb = tengine.ContinuousBatcher(tbuild(tcfg), tp, batch_size=2,
                                   max_len=MAX_LEN, device="cpu")
    for b, R in ((jb, JRequest), (tb, tengine.Request)):
        for i, (p, n) in enumerate(zip(prompts, news)):
            b.submit(R(rid=i, prompt=p, max_new_tokens=n))
    want, got = jb.run(), tb.run()
    assert got == want
    assert [len(got[i]) for i in range(3)] == list(news)
    assert (tb.steps, tb.tokens_out) == (jb.steps, jb.tokens_out)


def test_serve_lm_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "starcoder2-7b", "--device", "cpu",
                      "--requests", "3", "--batch", "2", "--max-new", "3",
                      "--max-len", "32"])
    assert sorted(out) == [0, 1, 2] and all(len(t) == 3 for t in out.values())
    assert "[serve] starcoder2-7b on cpu" in capsys.readouterr().out


def test_reduced_flag_can_be_turned_off(monkeypatch):
    """``--no-reduced`` reaches serve_lm (the reference's store_true flag
    with default True could not be turned off)."""
    from repro_torch.launch import serve
    seen = []
    monkeypatch.setattr(serve, "serve_lm", lambda a: seen.append(a.reduced))
    monkeypatch.setattr(serve, "serve_graph",
                        lambda a: seen.append(a.workload))
    serve.main(["--no-reduced"])
    serve.main([])
    serve.main(["--reduced"])
    serve.main(["--workload", "graph"])
    assert seen == [False, True, True, "graph"]


# ---------------------------------------------------------------------------
# the traps, one by one against the JAX package's functions


def test_gelu_is_the_tanh_approximation():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 16)).astype(np.float32) * 3
    p = {"wi": rng.normal(size=(16, 32)).astype(np.float32),
         "wo": rng.normal(size=(32, 16)).astype(np.float32)}
    want = jL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act="gelu")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tL.apply_mlp(tp, torch.from_numpy(x), act="gelu")
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)
    h = torch.from_numpy(x) @ tp["wi"]
    exact = torch.nn.functional.gelu(h) @ tp["wo"]
    assert float((exact - got).abs().max()) > 1e-3


def test_rope_matches_jax_in_prefill_and_decode():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 3, 16)).astype(np.float32)
    pos = np.arange(6)
    np.testing.assert_allclose(
        _np(tL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)),
        _np(jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=1e-5, atol=1e-5)
    # decode: one token per sequence at its own length
    x1 = x[:, :1]
    length = np.array([7, 4093], np.int32)
    np.testing.assert_allclose(
        _np(tL.apply_rope(torch.from_numpy(x1),
                          torch.from_numpy(length)[:, None], 1e4)),
        _np(jL.apply_rope(jnp.asarray(x1), jnp.asarray(length)[:, None],
                          1e4)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_use_eps_1e6(kind):
    """At a variance near eps the result depends on eps itself."""
    rng = np.random.default_rng(6)
    x = (1e-3 * rng.normal(size=(4, 32))).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 32).astype(np.float32),
         "bias": rng.normal(size=32).astype(np.float32)}
    if kind == "rmsnorm":
        p.pop("bias")
    want = jL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    got = tL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), kind)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_unembed_masks_padded_vocab():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 8)).astype(np.float32)
    w = rng.normal(size=(8, 20)).astype(np.float32)
    want = jL.unembed({"unembed": jnp.asarray(w)}, jnp.asarray(x), 13)
    got = tL.unembed({"unembed": torch.from_numpy(w)}, torch.from_numpy(x),
                     13)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    assert (_np(got)[:, 13:] == -1e9).all()


def test_qkv_bias_is_added_before_rope():
    rng = np.random.default_rng(8)
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("wq", (8, 2, 4)), ("wk", (8, 1, 4)), ("wv", (8, 1, 4)),
        ("bq", (2, 4)), ("bk", (1, 4)), ("bv", (1, 4)))}
    x = rng.normal(size=(1, 5, 8)).astype(np.float32)
    pos = np.arange(3, 8)
    want = jattn.qkv_proj({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = tattn.qkv_proj({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5)


def test_cache_update_in_place_equals_one_hot_blend():
    """Including a sequence whose length is past the cache's end (the
    blend writes nothing there)."""
    rng = np.random.default_rng(9)
    kc, vc = (rng.normal(size=(3, 6, 2, 4)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.normal(size=(3, 1, 2, 4)).astype(np.float32)
              for _ in range(2))
    length = np.array([0, 5, 6], np.int32)
    want = jattn.cache_update_local(*map(jnp.asarray, (kc, vc, kn, vn,
                                                       length)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = tattn.cache_update_local(tk, tv, *map(torch.from_numpy,
                                                (kn, vn, length)))
    assert got[0] is tk and got[1] is tv
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_greedy_sample_takes_the_first_of_a_tie():
    logits = np.array([[0.0, 3.0, 1.0, 3.0], [2.0, 2.0, 2.0, 2.0]],
                      np.float32)
    got = tengine.greedy_sample(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.argmax(logits, -1)))
    np.testing.assert_array_equal(got.numpy(), [1, 0])


def test_insert_slot_copies_one_slot_in_place():
    cfg = tget("starcoder2-7b").reduced()
    m = tbuild(cfg)
    st = m.decode_state_init(3, 8, device="cpu")
    ps = m.decode_state_init(1, 8, filled=5, device="cpu")
    ps.kv.k.normal_()
    ps.kv.v.normal_()
    out = tengine.insert_slot(st, ps, 1)
    assert out is st
    assert torch.equal(st.kv.k[:, 1], ps.kv.k[:, 0])
    assert torch.equal(st.kv.v[:, 1], ps.kv.v[:, 0])
    assert not st.kv.k[:, [0, 2]].any()
    assert st.kv.length.tolist() == [0, 5, 0]


def test_storage_dtypes_and_family_guard():
    """bf16 block weights and embedding, f32 norms and unembed; a family
    the port does not know raises a ValueError, in ``Model.init`` and in
    the decoder-only assembly."""
    _, _, tcfg, tp = _setup("starcoder2-7b", "bfloat16")
    assert tp["stack"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["stack"]["attn"]["bq"].dtype == torch.bfloat16
    assert tp["stack"]["ln1"]["scale"].dtype == torch.float32
    assert tp["embed"]["embedding"].dtype == torch.bfloat16
    assert tp["embed"]["unembed"].dtype == torch.float32
    assert tp["final_norm"]["scale"].dtype == torch.float32
    unknown = dataclasses.replace(tcfg, family="diffusion")
    with pytest.raises(ValueError, match="diffusion"):
        tbuild(unknown).init(device="cpu")
    with pytest.raises(ValueError, match="diffusion"):
        ttfm.layer_plan(unknown)
