"""The port's encdec family (whisper-base: an audio encoder over stub frame
embeddings, a causal decoder with cross-attention) against the JAX
package's.

The tests start from the JAX package's ``Model.init(PRNGKey(0))`` weights
of the ``reduced()`` config (2 encoder and 2 decoder layers, d_model 64),
carried across with ``convert.lm_params_from_arrays``; the layernorms'
scales and biases get seeded numpy noise first, so that their order of use
is tested too.  Frames (``0.1 * N(0, 1)``, 1,500 of them unless a test
says otherwise, as the reference's tests) and prompts are numpy from a
seed.  On the CPU the port's attention runs the flash kernel's plain
version: non-causal with ``kv_len = F`` over the padded frames.  The
reference's prefill and decode are called as they are, not under one
``jax.jit``: compiled whole, XLA fuses the encoder's layers and moves its
memory by up to 1.9e-4 against its own unjitted call (frames of 1,500,
memory |max| ~4.2), while the port agrees with the unjitted call within
2.1e-6.

Tolerances.  Encoder memory and caches: float32 ``rtol=atol=1e-5``;
bfloat16 ``test_torch_lm.py``'s ``BF16_CACHE`` (``atol=0.05``).  Logits:
float32 ``rtol=atol=1e-5`` and bfloat16 ``BF16_LOGITS`` (``atol=0.08``),
set at the dense configs' logits of |max| ~3.5, with the absolute part
scaled by the logits' own range, as ``test_torch_rglru.py`` does: whisper
ties its embedding, so its reduced logits reach |max| ~34 (the float32
logits differ by up to 1.7e-5 between the two frameworks, the bf16 ones
by 0.18, when the tolerances were set).
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.serve.engine import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

ARCH = "whisper-base"
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_LOGITS = dict(rtol=0, atol=0.08)
BF16_CACHE = dict(rtol=0, atol=0.05)
#: |max| of the dense configs' reduced logits, where BF16_LOGITS was set
DENSE_LOGIT_SCALE = 3.5
MAX_LEN = 32


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _logits_tol(want, tol):
    """``tol`` with its ``atol`` scaled by |max| of the logits over the
    dense configs' (see the module docstring)."""
    scale = max(1.0, float(np.abs(_np(want)).max()) / DENSE_LOGIT_SCALE)
    return dict(tol, atol=tol["atol"] * scale)


def _perturb(tree, seed=0):
    """Noise on the layernorms (the reference inits them to ones and
    zeros)."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path[-1] == "bias":
            return (node + 0.1 * rng.normal(size=node.shape)).astype(
                node.dtype)
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
    return (jcfg, jax.tree.map(jnp.asarray, tree), (jm.prefill, jm.decode),
            tcfg,
            lm_params_from_arrays(tree, tcfg, device="cpu"), tree)


def _inputs(seed, B, S, cfg, F=tencdec.N_FRAMES):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S))
    frames = (0.1 * rng.normal(size=(B, F, cfg.d_model))).astype(np.float32)
    return tok, frames


def _batches(tok, frames):
    return ({"tokens": jnp.asarray(tok), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(tok),
             "frames": torch.from_numpy(frames)})


def _compare_state(jst, tst, tol):
    np.testing.assert_array_equal(_np(tst.self_kv.length),
                                  _np(jst.self_kv.length))
    for got, want in ((tst.self_kv.k, jst.self_kv.k),
                      (tst.self_kv.v, jst.self_kv.v),
                      (tst.cross_k, jst.cross_k), (tst.cross_v, jst.cross_v)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_sinusoidal_matches_jax():
    """The frequencies bit for bit (the reference's float32 exp on the
    CPU, ``_exp_f32``, held over [-20, 5]: the frequencies' exponents lie
    in [-log(10000), 0]), the table within an ulp of sin and cos, at the
    reduced and the full width over every padded frame."""
    x = np.random.default_rng(0).uniform(-20, 5, 50000).astype(np.float32)
    np.testing.assert_array_equal(tencdec._exp_f32(x),
                                  np.asarray(jnp.exp(jnp.asarray(x))))
    pos = np.arange(tencdec.N_FRAMES_PAD)
    for d in (64, 512):
        half = d // 2
        np.testing.assert_array_equal(
            tencdec._freqs(d),
            np.asarray(jnp.exp(-np.log(10000.0) * jnp.arange(half)
                               / max(half - 1, 1))))
        np.testing.assert_allclose(
            tencdec.sinusoidal(torch.from_numpy(pos), d).numpy(),
            np.asarray(jencdec.sinusoidal(jnp.asarray(pos), d)),
            rtol=0, atol=2e-7)


def test_params_carry_across_and_storage_dtypes():
    """The reference's tree (``embed``, ``encoder``, ``decoder`` with
    ``ln_x`` and ``xattn``, ``enc_norm``, ``final_norm``) carried across;
    ``Model.init`` builds the same shapes; in bf16 compute the matmul
    weights are bf16, every norm and the tied embedding float32."""
    _, _, _, tcfg, tp, tree = _setup("bfloat16")

    def shapes(node):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in node.items()}
    assert sorted(tp) == ["decoder", "embed", "enc_norm", "encoder",
                          "final_norm"]
    assert shapes(tp) == shapes(tree)
    assert shapes(tbuild(tcfg).init(device="cpu")) == shapes(tree)
    dec = tp["decoder"]
    assert dec["xattn"]["wk"].dtype == dec["mlp"]["wi"].dtype == \
        tp["encoder"]["attn"]["wq"].dtype == torch.bfloat16
    for norm in (dec["ln1"], dec["ln2"], dec["ln_x"], tp["encoder"]["ln1"],
                 tp["enc_norm"], tp["final_norm"]):
        assert norm["scale"].dtype == norm["bias"].dtype == torch.float32
    np.testing.assert_array_equal(tp["enc_norm"]["bias"].numpy(),
                                  tree["enc_norm"]["bias"])
    assert tp["embed"]["embedding"].dtype == torch.float32       # tied


@pytest.mark.parametrize("F", [tencdec.N_FRAMES, 100])
def test_encode_matches_jax(F):
    """The encoder's memory over the padded frames (non-causal, the padded
    frames masked by ``kv_len = F``), padded rows included."""
    jcfg, jp, _, tcfg, tp, _ = _setup("float32")
    _, frames = _inputs(4, 2, 1, jcfg, F)
    jmem, jmask = jencdec.encode(jp, jcfg, jnp.asarray(frames))
    tmem, kv_len = tencdec.encode(tp, tcfg, torch.from_numpy(frames))
    assert kv_len == F and int(np.asarray(jmask).sum(1)[0]) == F
    assert tuple(tmem.shape) == (2, tencdec.N_FRAMES_PAD, tcfg.d_model)
    np.testing.assert_allclose(_np(tmem), _np(jmem), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """Prefill of 12 tokens over 1,500 frames: its last logits, the self
    and cross caches, then 4 decode steps (fed the JAX package's greedy
    tokens) and the caches after them."""
    jcfg, jp, (jpre, jdec), tcfg, tp, _ = _setup(dtype)
    ltol, ctol = ((F32, F32) if dtype == "float32"
                  else (BF16_LOGITS, BF16_CACHE))
    jb, tb = _batches(*_inputs(1, 2, 12, jcfg))
    jlast, jst = jpre(jp, jb, max_len=MAX_LEN)
    tm = tbuild(tcfg)
    tlast, tst = tm.prefill(tp, tb, max_len=MAX_LEN)
    assert tlast.dtype == torch.float32
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


@pytest.mark.parametrize("F", [tencdec.N_FRAMES, 100])
def test_decode_reads_the_reference_cross_slots(F):
    """ROADMAP C7: the prefill's cross-attention masks frames ``>= F``, but
    decode attends ``min(N_FRAMES, F_pad) = 1500`` cross slots whatever F
    is, so with F = 100 it reads encoder outputs at padded frames.  The
    port computes what the reference computes at both F (prefill and three
    decode steps), and its decode does read slot 1,499 and not slot 1,500:
    changing the cached cross key there moves the logits, or leaves them."""
    jcfg, jp, (jpre, jdec), tcfg, tp, _ = _setup("float32")
    jb, tb = _batches(*_inputs(5, 1, 8, jcfg, F))
    jlast, jst = jpre(jp, jb, max_len=MAX_LEN)
    tm = tbuild(tcfg)
    tlast, tst = tm.prefill(tp, tb, max_len=MAX_LEN)
    np.testing.assert_allclose(_np(tlast), _np(jlast),
                               **_logits_tol(jlast, F32))
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jlast, -1))[:, None]
        jlast, jst = jdec(jp, jnp.asarray(nxt), jst)
        tlast, tst = tm.decode(tp, torch.tensor(nxt), tst)
        np.testing.assert_allclose(_np(tlast), _np(jlast),
                                   **_logits_tol(jlast, F32))
    nxt = torch.tensor(np.asarray(jnp.argmax(jlast, -1))[:, None])

    def decode_with_cross_key(slot):
        st = tencdec.EncDecState(
            self_kv=tst.self_kv._replace(k=tst.self_kv.k.clone(),
                                         v=tst.self_kv.v.clone()),
            cross_k=tst.cross_k.clone(), cross_v=tst.cross_v.clone())
        if slot is not None:
            st.cross_k[:, :, slot] += 1.0
        return tm.decode(tp, nxt, st)[0]
    base = decode_with_cross_key(None)
    assert not torch.equal(decode_with_cross_key(tencdec.N_FRAMES - 1), base)
    assert torch.equal(decode_with_cross_key(tencdec.N_FRAMES), base)


def test_insert_slot_copies_an_encdec_state_in_place():
    m = tbuild(tget(ARCH).reduced())
    st = m.decode_state_init(3, 16, device="cpu")
    ps = m.decode_state_init(1, 16, filled=5, device="cpu")
    assert tuple(st.cross_k.shape)[2] == tencdec.N_FRAMES_PAD
    for t in (ps.self_kv.k, ps.self_kv.v, ps.cross_k, ps.cross_v):
        t.normal_()
    out = tengine.insert_slot(st, ps, 1)
    assert out is st
    for dst, src in ((st.self_kv.k, ps.self_kv.k), (st.self_kv.v,
                                                    ps.self_kv.v),
                     (st.cross_k, ps.cross_k), (st.cross_v, ps.cross_v)):
        assert torch.equal(dst[:, 1], src[:, 0])
        assert not dst[:, [0, 2]].any()
    assert st.self_kv.length.tolist() == [0, 5, 0]


def test_continuous_batching_matches_jax():
    """Three requests with 1,500 frames each through a batch of two: the
    second slot is refilled by a batch-1 prefill (encoder included)
    inserted mid-run; every token equals the JAX package's batcher's, in
    float32 compute."""
    jcfg, jp, _, tcfg, tp, _ = _setup("float32")
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, jcfg.vocab, T).astype(np.int32),
             (0.1 * rng.normal(size=(tencdec.N_FRAMES, jcfg.d_model))
              ).astype(np.float32), n)
            for T, n in ((5, 5), (9, 3), (7, 4))]
    jb = JBatcher(jbuild(jcfg), jp, batch_size=2, max_len=MAX_LEN)
    tb = tengine.ContinuousBatcher(tbuild(tcfg), tp, batch_size=2,
                                   max_len=MAX_LEN, device="cpu")
    for b, R in ((jb, JRequest), (tb, tengine.Request)):
        for i, (p, frames, n) in enumerate(reqs):
            b.submit(R(rid=i, prompt=p, max_new_tokens=n,
                       extras={"frames": frames}))
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
