"""The port's vlm family (paligemma-3b: a dense decoder behind an image
prefix, attended with the prefix-LM mask) against the JAX package's.

The tests start from the JAX package's ``Model.init(PRNGKey(0))`` weights
of the ``reduced()`` config (8 image tokens, 2 layers), carried across with
``convert.lm_params_from_arrays``; the norms' scales get seeded numpy noise
first, so that their order of use is tested too.  Image embeddings
(``0.1 * N(0, 1)``, as the reference's tests) and prompts are numpy from a
seed.  On the CPU the port's attention runs the flash kernel's plain
version with ``prefix_len``.

Tolerances.  Caches: float32 ``rtol=atol=1e-5``; bfloat16
``test_torch_lm.py``'s ``BF16_CACHE`` (``atol=0.05``).  Logits: float32
``rtol=atol=1e-5`` and bfloat16 ``BF16_LOGITS`` (``atol=0.08``), set at the
dense configs' logits of |max| ~3.5, with the absolute part scaled by the
logits' own range, as ``test_torch_rglru.py`` does: paligemma ties its
embedding (rows N(0, 1), no 1/sqrt(d) unembed scale), so its reduced
logits reach |max| ~42 and their float32 sums round ~12x as far (1.05e-5
between the two frameworks when the tolerance was set).
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.serve.engine import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

ARCH = "paligemma-3b"
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
    """Noise on the norms' scales (the reference inits them to ones)."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path[-1] == "scale":
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


def _inputs(seed, B, S, cfg):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S))
    img = (0.1 * rng.normal(size=(B, cfg.num_image_tokens, cfg.d_model))
           ).astype(np.float32)
    return tok, img


def _batches(tok, img):
    return ({"tokens": jnp.asarray(tok), "image_embeds": jnp.asarray(img)},
            {"tokens": torch.from_numpy(tok),
             "image_embeds": torch.from_numpy(img)})


def _compare_state(jst, tst, tol):
    np.testing.assert_array_equal(_np(tst.kv.length), _np(jst.kv.length))
    np.testing.assert_allclose(_np(tst.kv.k), _np(jst.kv.k), **tol)
    np.testing.assert_allclose(_np(tst.kv.v), _np(jst.kv.v), **tol)


def test_params_carry_across_and_storage_dtypes():
    """The reference's tree carried across; ``Model.init`` builds the same
    shapes; bf16 block weights, the tied embedding and the norms float32."""
    _, _, _, tcfg, tp, tree = _setup("bfloat16")

    def shapes(node):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in node.items()}
    assert shapes(tp) == shapes(tree)
    assert shapes(tbuild(tcfg).init(device="cpu")) == shapes(tree)
    assert tp["stack"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["stack"]["mlp"]["wg"].dtype == torch.bfloat16
    assert tp["stack"]["ln1"]["scale"].dtype == torch.float32
    assert tp["embed"]["embedding"].dtype == torch.float32       # tied
    np.testing.assert_array_equal(tp["embed"]["embedding"].numpy(),
                                  tree["embed"]["embedding"])
    m = tbuild(tcfg)
    assert m.n_attn_layers() == tcfg.n_layers
    st = m.decode_state_init(2, MAX_LEN, filled=3, device="cpu")
    assert tuple(st.kv.k.shape) == (2, 2, MAX_LEN, tcfg.n_kv_heads, 16)
    assert st.kv.length.tolist() == [3, 3]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """Prefill of 8 image positions and 12 tokens (one pass): its last
    logits and KV cache, then 4 decode steps (fed the JAX package's greedy
    tokens) and the cache after them."""
    jcfg, jp, (jpre, jdec), tcfg, tp, _ = _setup(dtype)
    ltol, ctol = ((F32, F32) if dtype == "float32"
                  else (BF16_LOGITS, BF16_CACHE))
    jb, tb = _batches(*_inputs(1, 2, 12, jcfg))
    jlast, jst = jpre(jp, jb, max_len=MAX_LEN)
    tm = tbuild(tcfg)
    tlast, tst = tm.prefill(tp, tb, max_len=MAX_LEN)
    assert tlast.dtype == torch.float32
    assert tst.kv.length.tolist() == [8 + 12] * 2
    np.testing.assert_allclose(_np(tlast), _np(jlast),
                               **_logits_tol(jlast, ltol))
    _compare_state(jst, tst, ctol)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jlast, -1))[:, None]
        jlast, jst = jdec(jp, jnp.asarray(nxt), jst)
        tlast, tst = tm.decode(tp, torch.tensor(nxt), tst)
        np.testing.assert_allclose(_np(tlast), _np(jlast),
                                   **_logits_tol(jlast, ltol))
    _compare_state(jst, tst, ctol)


@pytest.mark.parametrize("chunk", [8, 4])
def test_chunked_prefill_matches_jax(chunk):
    """8 image positions and 8 tokens, 16 positions in chunks of 8 (the
    prefix fills the first chunk) or 4 (the prefix spans two chunks; the
    first chunk's queries see only the cache filled so far, in both
    packages)."""
    jcfg, jp, _, tcfg, tp, _ = _setup("float32")
    tok, img = _inputs(2, 1, 8, jcfg)
    jlast, jst = jtfm.prefill(jp, jcfg, jnp.asarray(tok), max_len=MAX_LEN,
                              prefix_embeds=jnp.asarray(img),
                              prefix_len=jcfg.num_image_tokens, chunk=chunk)
    tlast, tst = ttfm.prefill(tp, tcfg, torch.from_numpy(tok),
                              max_len=MAX_LEN,
                              prefix_embeds=torch.from_numpy(img),
                              prefix_len=tcfg.num_image_tokens, chunk=chunk)
    np.testing.assert_allclose(_np(tlast), _np(jlast),
                               **_logits_tol(jlast, F32))
    _compare_state(jst, tst, F32)


def test_prefill_branches_count_the_prefix(monkeypatch):
    """The chunking test counts the image positions: 8 + 8 positions are
    chunked at 8, 8 + 4 are not."""
    taken = []
    monkeypatch.setattr(ttfm, "_prefill_chunked",
                        lambda *a, **k: taken.append("chunked"))
    monkeypatch.setattr(ttfm, "_prefill_whole",
                        lambda *a, **k: taken.append("whole"))
    cfg = tget(ARCH).reduced()
    img = torch.zeros((1, 8, cfg.d_model))
    for S in (8, 4):
        ttfm.prefill(None, cfg, torch.zeros((1, S), dtype=torch.long),
                     max_len=24, prefix_embeds=img, prefix_len=8, chunk=8)
    assert taken == ["chunked", "whole"]


def test_vlm_prefix_is_bidirectional():
    """The JAX package's ``test_vlm_prefix_is_bidirectional`` on the port's
    serving path: changing the LAST image patch must change the layer-1
    keys at position 0 (layer 0's output there sees the whole prefix),
    which a causal mask would leave as they are; the text positions'
    change in both."""
    _, _, _, tcfg, tp, _ = _setup("float32")
    tm = tbuild(tcfg)
    tok, img = _inputs(0, 1, 8, tcfg)
    img2 = img.copy()
    img2[:, -1] += 1.0
    P = tcfg.num_image_tokens

    def layer1_keys(image, prefix_len):
        _, st = ttfm.prefill(tp, tcfg, torch.from_numpy(tok), max_len=24,
                             prefix_embeds=torch.from_numpy(image),
                             prefix_len=prefix_len)
        return st.kv.k[1, 0]
    base, pert = layer1_keys(img, P), layer1_keys(img2, P)
    assert float((base[0] - pert[0]).abs().max()) > 0
    assert float((base[P] - pert[P]).abs().max()) > 0
    assert torch.equal(layer1_keys(img, None)[:P - 1],
                       layer1_keys(img2, None)[:P - 1])
    # and the batch through Model.prefill takes the prefix from the config
    _, st = tm.prefill(tp, {"tokens": torch.from_numpy(tok),
                            "image_embeds": torch.from_numpy(img2)},
                       max_len=24)
    assert torch.equal(st.kv.k[1, 0], pert)


def test_continuous_batching_matches_jax():
    """Three requests with image embeddings through a batch of two: the
    second slot is refilled by a batch-1 prefill of its image and prompt
    inserted mid-run; every token equals the JAX package's batcher's, in
    float32 compute."""
    jcfg, jp, _, tcfg, tp, _ = _setup("float32")
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, jcfg.vocab, T).astype(np.int32),
             (0.1 * rng.normal(size=(jcfg.num_image_tokens, jcfg.d_model))
              ).astype(np.float32), n)
            for T, n in ((5, 5), (9, 3), (7, 4))]
    jb = JBatcher(jbuild(jcfg), jp, batch_size=2, max_len=MAX_LEN)
    tb = tengine.ContinuousBatcher(tbuild(tcfg), tp, batch_size=2,
                                   max_len=MAX_LEN, device="cpu")
    for b, R in ((jb, JRequest), (tb, tengine.Request)):
        for i, (p, img, n) in enumerate(reqs):
            b.submit(R(rid=i, prompt=p, max_new_tokens=n,
                       extras={"image_embeds": img}))
    want, got = jb.run(), tb.run()
    assert got == want
    assert [len(got[i]) for i in range(3)] == [5, 3, 4]
    assert (tb.steps, tb.tokens_out) == (jb.steps, jb.tokens_out)


def test_serve_lm_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                      "--batch", "2", "--max-new", "3"])
    assert sorted(out) == [0, 1, 2] and all(len(t) == 3 for t in out.values())
    assert f"[serve] {ARCH} on cpu" in capsys.readouterr().out
