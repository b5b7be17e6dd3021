"""The port's flash-attention plain version and wrapper against the JAX
package's flash attention and ``attend``.

On the CPU the port's ``flash_attention`` and ``attend`` run the kernel's
plain version (``kernels/flash_attention/ref.py``); the JAX side runs the
Pallas kernel in interpret mode, as the JAX package's own tests do, or its
XLA twin ``models.attention.attend``.  Inputs are made with numpy from a
seed and handed to both.

Tolerances are the JAX suite's own: float32 ``atol=1e-5`` (the softmax and
the sums run in another order: one pass against the online blocks), bf16
``atol=2e-2`` (about two bf16 ulps at unit scale: both round the float32
result once, but the float32 results differ in the last bits).  The card's
bf16 kernel rounds p to bf16 for p.v; a plain-torch emulation of its
arithmetic (below) holds the card's tolerance, ``rtol=atol=8e-3``, against
the JAX kernel and the plain version.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention.flash import \
    flash_attention_pallas_call  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_mask, flash_attention_gqa_ref, flash_attention_ref,
    flash_attention_split_ref)
from repro_torch.models import attention as tattn  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(seed, B, Sq, Skv, H, Hkv, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd))]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=0)


# the JAX package's flash sweep (tests/test_kernels_pallas.py)
SWEEP = [
    (2, 64, 64, 4, 4, 32, True, None),     # MHA causal
    (1, 48, 80, 4, 2, 16, True, None),     # GQA, cross lengths, pad path
    (2, 32, 32, 8, 1, 64, False, None),    # MQA non-causal
    (1, 128, 128, 4, 4, 32, True, 32),     # windowed
    (1, 16, 300, 2, 2, 8, False, None),    # KV padding
]


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,hd,causal,window", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_flash(B, Sq, Skv, H, Hkv, hd, causal,
                                         window, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(Sq * 7 + Skv, B, Sq, Skv, H, Hkv, hd,
                                   dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                interpret=True)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("kv_len", [80, 37, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_kv_len_matches_the_pallas_call(kv_len, causal):
    """The TPU kernel's ``kv_len`` (keys past it are padding) against the
    plain version's, on ``[BH, S, hd]`` at the kernel's tile sizes."""
    rng = np.random.default_rng(kv_len)
    q, k, v = (rng.normal(size=(3, s, 16)).astype(np.float32)
               for s in (128, 256, 256))
    want = flash_attention_pallas_call(*map(jnp.asarray, (q, k, v)),
                                       causal=causal, kv_len=kv_len,
                                       interpret=True)
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, kv_len=kv_len)
    _close(got, want, "float32")


@pytest.mark.parametrize("Sq,off,Hkv", [(16, 16, 2), (8, 40, 1), (24, 0, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_offset_matches_jax_attend(Sq, off, Hkv, dtype):
    """The chunked prefill's call: queries at ``off + arange(Sq)`` against
    keys ``arange(off + Sq)``."""
    B, H, hd = 2, 4, 16
    Skv = off + Sq
    (jq, jk, jv), (q, k, v) = _qkv(Sq + off, B, Sq, Skv, H, Hkv, hd, dtype)
    want = jattn.attend(jq, jk, jv, off + jnp.arange(Sq), jnp.arange(Skv),
                        causal=True, chunk=8)
    got = tattn.attend(q, k, v, off, causal=True)
    _close(got, want, dtype)


def test_window_matches_jax_attend():
    (jq, jk, jv), (q, k, v) = _qkv(5, 1, 16, 40, 4, 2, 16, "float32")
    want = jattn.attend(jq, jk, jv, 24 + jnp.arange(16), jnp.arange(40),
                        causal=True, window=8, chunk=16)
    got = tattn.attend(q, k, v, 24, causal=True, window=8)
    _close(got, want, "float32")


@pytest.mark.parametrize("prefix_len", [0, 1, 7, 24])
@pytest.mark.parametrize("Sq,off,Hkv", [(24, 0, 2), (16, 8, 1)])
def test_prefix_len_matches_jax_attend(prefix_len, Sq, off, Hkv):
    """The vlm's prefix-LM mask: causal, keys ``< prefix_len`` seen by every
    query (a prefix of 0, 1, 7 and the whole of Sq), GQA and MQA, with and
    without a query offset (a chunk after the first)."""
    B, H, hd = 2, 4, 16
    Skv = off + Sq
    (jq, jk, jv), (q, k, v) = _qkv(prefix_len + Sq, B, Sq, Skv, H, Hkv, hd,
                                   "float32")
    want = jattn.attend(jq, jk, jv, off + jnp.arange(Sq), jnp.arange(Skv),
                        causal=True, chunk=8, prefix_len=prefix_len)
    got = tattn.attend(q, k, v, off, causal=True, prefix_len=prefix_len)
    _close(got, want, "float32")
    if prefix_len > off + 1:
        # the prefix changes the answer: a query before prefix_len - 1
        # sees keys past its own position
        assert not torch.allclose(got, tattn.attend(q, k, v, off,
                                                    causal=True))


@pytest.mark.parametrize("Sq,Skv,kv_len", [(24, 40, 33), (40, 40, 1),
                                           (8, 48, 47)])
def test_non_causal_kv_len_matches_jax_kv_mask(Sq, Skv, kv_len):
    """encdec's encoder and cross-attention: non-causal over padded keys,
    the reference's ``kv_mask = arange(Skv) < kv_len`` in every row as the
    plain version's ``kv_len``."""
    (jq, jk, jv), (q, k, v) = _qkv(kv_len, 2, Sq, Skv, 4, 4, 16, "float32")
    kv_mask = jnp.broadcast_to(jnp.arange(Skv)[None] < kv_len, (2, Skv))
    want = jattn.attend(jq, jk, jv, jnp.arange(Sq), jnp.arange(Skv),
                        causal=False, chunk=16, kv_mask=kv_mask)
    got = tattn.attend(q, k, v, 0, causal=False, kv_len=kv_len)
    _close(got, want, "float32")


def test_strided_cache_prefix_equals_contiguous_copy():
    """``attend`` on a prefix view of a ``[B, S, Hkv, hd]`` cache (what the
    chunked prefill passes) equals the call on a contiguous copy."""
    _, (q, k, v) = _qkv(9, 2, 8, 32, 4, 2, 16, "float32")
    view_k, view_v = k[:, :20], v[:, :20]
    assert not view_k.is_contiguous()
    got = tattn.attend(q, view_k, view_v, 12)
    want = flash_attention_gqa_ref(q, view_k.contiguous(),
                                   view_v.contiguous(), q_offset=12)
    assert torch.equal(got, want)


def test_cpu_dispatch_counts_no_launch_and_validates():
    _, (q, k, v) = _qkv(1, 1, 8, 8, 4, 2, 16, "float32")
    ops.reset_launches()
    ops.flash_attention(q, k, v)
    assert ops.LAUNCHES == {"flash_attention": 0}
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="dtypes"):
        ops.flash_attention(q, k.double(), v)


def test_fully_masked_rows_are_zero():
    """A query that sees no key (``kv_len = 0``) gets 0, as the
    reference's ``acc / max(l, 1e-30)`` with ``l = 0``."""
    _, (q, k, v) = _qkv(2, 1, 4, 8, 2, 2, 16, "float32")
    out = ops.flash_attention(q, k, v, kv_len=0)
    assert torch.equal(out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# the float32 kernel's key splits (csrc/flash_attention.cu,
# flash_fp32_kernel): each split's (m, l, acc) over its share of a q tile's
# chunks and their merge in cluster-rank order, modelled in plain torch
# (ref.flash_attention_split_ref) at 16-row tiles of 8-key chunks

#: (Sq, Skv, H, Hkv, splits, masks): causal; a window whose lower edge
#: leaves fewer chunks than splits (empty splits; rows that see none of a
#: split's keys); a prefix; a kv_len that ends inside a split's last chunk;
#: queries at an offset; a row that sees no key
SPLIT_CASES = {
    "causal": (48, 48, 4, 2, 2, dict(causal=True)),
    "window_empties_splits": (16, 64, 4, 1, 8,
                              dict(causal=True, window=5, q_offset=48)),
    "prefix": (32, 32, 4, 4, 4, dict(causal=True, prefix_len=12)),
    "kv_len_inside_split": (24, 64, 4, 2, 2,
                            dict(causal=False, kv_len=37)),
    "q_offset": (16, 40, 4, 2, 4, dict(causal=True, q_offset=24)),
    "no_key": (16, 24, 2, 2, 4, dict(causal=False, kv_len=0)),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_merge_arithmetic_matches_jax_attend(case):
    """The splits' fixed-order merge against the JAX reference's attention
    at the float32 tolerance; a row that sees no key is 0."""
    Sq, Skv, H, Hkv, splits, kw = SPLIT_CASES[case]
    (jq, jk, jv), (q, k, v) = _qkv(Sq + Skv + splits, 2, Sq, Skv, H, Hkv,
                                   16, "float32")
    off, kv_len = kw.get("q_offset", 0), kw.get("kv_len")
    kv_mask = (None if kv_len is None else jnp.broadcast_to(
        jnp.arange(Skv)[None] < kv_len, (2, Skv)))
    want = jattn.attend(jq, jk, jv, off + jnp.arange(Sq), jnp.arange(Skv),
                        causal=kw["causal"], window=kw.get("window"),
                        chunk=8, kv_mask=kv_mask,
                        prefix_len=kw.get("prefix_len"))
    got = flash_attention_split_ref(q, k, v, rows=16, chunk=8,
                                    splits=splits, **kw)
    _close(got, want, "float32")
    if case == "no_key":
        assert torch.equal(got, torch.zeros_like(got))
    # the same merge with one split is the plain version's arithmetic
    one = flash_attention_split_ref(q, k, v, rows=16, chunk=8, splits=1,
                                    **kw)
    torch.testing.assert_close(got, one, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the tensor-core kernel's arithmetic (csrc/flash_attention.cu,
# flash_tc_kernel), emulated in plain torch: it backs the card's bf16
# tolerance before any card run

#: keys per chunk of the tensor-core kernel (TcShape::KC): 128, 64 at hd 256
def _tc_chunk(hd):
    return 64 if hd > 160 else 128



#: the card's bf16 tolerance (chip_smoke.FLASH_TOL, test_torch_cuda): p
#: rounded to bf16 for p.v moves an output by at most 2^-9 max|v|, on top
#: of one output ulp
TC_TOL = dict(rtol=8e-3, atol=8e-3)


def _tc_emulation(q, k, v, *, causal=True, window=None, q_offset=0,
                  kv_len=None, prefix_len=None):
    """bf16 q [B,Sq,H,hd], k/v [B,Skv,Hkv,hd] -> bf16 [B,Sq,H,hd], as the
    tensor-core kernel computes it: chunks of 128 keys (64 at hd 256) with
    the online-softmax carry; s = q.k from the bf16 values in f32, scaled after the product,
    p = exp2(s c - m c) with c = log2(e)/sqrt(hd); l sums the f32 p; p is
    rounded to bf16 as the operand of p.v; out = acc / max(l, 1e-30)."""
    B, Sq, H, hd = q.shape
    Skv, g = k.shape[1], H // k.shape[2]
    qf = q.float().transpose(1, 2)                          # [B,H,Sq,hd]
    kf = k.float().repeat_interleave(g, 2).transpose(1, 2)  # [B,H,Skv,hd]
    vf = v.float().repeat_interleave(g, 2).transpose(1, 2)
    scale = float(np.float32(1.0 / hd ** 0.5))          # the wrapper's f32
    c = float(np.float32(scale * np.log2(np.e)))
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len,
                          prefix_len=prefix_len)
    m = torch.full((B, H, Sq), -torch.inf)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, hd))
    kc = _tc_chunk(hd)
    for c0 in range(0, Skv, kc):
        s = qf @ kf[:, :, c0:c0 + kc].transpose(-1, -2)
        s = torch.where(mask[:, c0:c0 + kc], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == -torch.inf, 0.0, m_new * c)
        r = torch.exp2(m * c - mu)
        p = torch.exp2(s * c - mu[..., None])
        l = l * r + p.sum(-1)
        acc = acc * r[..., None] + (p.bfloat16().float()
                                    @ vf[:, :, c0:c0 + kc])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.bfloat16().transpose(1, 2)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,hd,causal,window", SWEEP)
def test_tensor_core_arithmetic_matches_jax_flash(B, Sq, Skv, H, Hkv, hd,
                                                  causal, window):
    """The tensor-core kernel's rounding (p in bf16 for p.v) stays within
    the card's bf16 tolerance of the JAX flash kernel (interpret mode,
    float32 math on the same bf16 inputs)."""
    (jq, jk, jv), (q, k, v) = _qkv(Sq * 7 + Skv, B, Sq, Skv, H, Hkv, hd,
                                   "bfloat16")
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                interpret=True)
    got = _tc_emulation(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TC_TOL)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,hd,q_offset,causal,window,kv_len", [
    (1, 200, 200, 36, 4, 128, 0, True, None, None),    # the path's GQA
    (2, 64, 320, 8, 2, 128, 256, True, None, None),    # chunk with offset
    (1, 100, 300, 4, 1, 64, 200, True, 32, None),      # window edge
    (2, 77, 300, 4, 4, 16, 0, False, None, 190),       # kv_len mid-chunk
    (1, 130, 130, 2, 2, 160, 0, True, None, None),     # head_dim 160
    (1, 200, 200, 10, 1, 256, 0, True, 100, None),     # recurrentgemma
    (2, 90, 250, 10, 1, 256, 160, True, None, 230),    # hd 256, kv_len
])
def test_tensor_core_arithmetic_matches_plain_version(B, Sq, Skv, H, Hkv, hd,
                                                      q_offset, causal,
                                                      window, kv_len):
    """What the card compares: the tensor-core arithmetic against the plain
    version (float32 math) on bf16 inputs, within the card's tolerance, at
    ragged tiles, masks that end mid-chunk and every kept head dim."""
    _tc_against_plain(B, Sq, Skv, H, Hkv, hd, causal=causal, window=window,
                      q_offset=q_offset, kv_len=kv_len)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,hd,causal,kv_len,prefix_len", [
    (1, 300, 300, 8, 1, 256, True, None, 100),     # paligemma's prefix
    (2, 100, 300, 8, 8, 64, False, 250, None),     # whisper's padded frames
])
def test_tensor_core_arithmetic_with_a_prefix_or_padded_frames(
        B, Sq, Skv, H, Hkv, hd, causal, kv_len, prefix_len):
    """The same at the vlm's and encdec's masks: a prefix ending mid-chunk
    at hd 256, and non-causal keys padded past ``kv_len`` at hd 64."""
    _tc_against_plain(B, Sq, Skv, H, Hkv, hd, causal=causal, kv_len=kv_len,
                      prefix_len=prefix_len)


def _tc_against_plain(B, Sq, Skv, H, Hkv, hd, **kw):
    """The emulation against the plain version on seeded bf16 inputs; a
    key past ``kv_len`` must not reach the output."""
    _, (q, k, v) = _qkv(Sq + Skv + hd, B, Sq, Skv, H, Hkv, hd, "bfloat16")
    kv_len = kw.get("kv_len")
    got = _tc_emulation(q, k, v, **kw)
    want = flash_attention_gqa_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, **TC_TOL)
    if kv_len is not None:
        # a masked key takes exactly zero probability: the values there
        # do not reach the output
        v2 = v.clone()
        v2[:, kv_len:] = 1e4
        assert torch.equal(_tc_emulation(q, k, v2, **kw), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 48])
def test_head_dim_256_mqa_matches_jax_flash(dtype, window):
    """recurrentgemma-2b's attention shape: head_dim 256, 10 query heads on
    one key/value head, the local window: the plain version (and so the
    port's ``attend`` on the CPU) against the JAX flash kernel in
    interpret mode."""
    (jq, jk, jv), (q, k, v) = _qkv(256, 1, 96, 96, 10, 1, 256, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                interpret=True)
    got = tattn.attend(q, k, v, 0, causal=True, window=window)
    assert got.shape == q.shape
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# the backward: ``ref.flash_attention_bwd_ref`` (FlashAttentionFn's backward
# on the card) against autograd through the plain forward and ``jax.grad``
# of the reference's ``attend``, float32 within 1e-5

BWD_MASKS = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=7),
    "prefix": dict(causal=True, prefix_len=9),
    "kv_len": dict(causal=False, kv_len=23),
    "q_offset": dict(causal=True, q_offset=12),
}


def _bwd_case(seed, mask, group):
    B, Sq, Hkv, hd = 2, 40, 2, 16
    Skv = Sq + mask.get("q_offset", 0)
    (jq, jk, jv), (tq, tk, tv) = _qkv(seed, B, Sq, Skv, Hkv * group, Hkv, hd,
                                      "float32")
    dout = np.random.default_rng(seed + 1).normal(
        size=(B, Sq, Hkv * group, hd)).astype(np.float32)
    return (jq, jk, jv), (tq, tk, tv), dout


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("mask", list(BWD_MASKS))
def test_flash_backward_matches_autograd_and_jax_grad(mask, group,
                                                      monkeypatch):
    from repro_torch.kernels.flash_attention import ref as fref
    kw = BWD_MASKS[mask]
    (jq, jk, jv), (tq, tk, tv), dout = _bwd_case(3, kw, group)
    # blocks of 16 queries: three blocks, the last one ragged
    monkeypatch.setattr(fref, "BWD_BLOCK", 16)
    out = flash_attention_gqa_ref(tq, tk, tv, **kw)
    got = fref.flash_attention_bwd_ref(tq, tk, tv, out,
                                       torch.from_numpy(dout), **kw)
    # autograd through the plain forward
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    flash_attention_gqa_ref(*leaves, **kw).backward(torch.from_numpy(dout))
    for g, x in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), x.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # jax.grad of the reference's attend
    Sq, Skv = tq.shape[1], tk.shape[1]
    kv_mask = None
    if "kv_len" in kw:
        kv_mask = jnp.broadcast_to(jnp.arange(Skv) < kw["kv_len"],
                                   (tq.shape[0], Skv))

    def f(q, k, v):
        o = jattn.attend(q, k, v, kw.get("q_offset", 0) + jnp.arange(Sq),
                         jnp.arange(Skv), causal=kw["causal"],
                         window=kw.get("window"), kv_mask=kv_mask,
                         prefix_len=kw.get("prefix_len"))
        return jnp.sum(o * jnp.asarray(dout))
    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_flash_attention_fn_plumbing(monkeypatch):
    """``FlashAttentionFn`` with its launch swapped for the plain forward
    (the CPU has no kernel): its gradients are ``flash_attention_bwd_ref``'s
    of the saved tensors, the masks passed through, and no gradient for
    the mask arguments."""
    kw = dict(causal=True, window=None, q_offset=0, kv_len=None,
              prefix_len=5)
    calls = []

    def launch(q, k, v, causal, window, q_offset, kv_len, prefix_len):
        calls.append((causal, window, q_offset, kv_len, prefix_len))
        return flash_attention_gqa_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, kv_len=kv_len,
                                       prefix_len=prefix_len)
    monkeypatch.setattr(ops, "_launch", launch)
    _, (tq, tk, tv), dout = _bwd_case(5, kw, 4)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = ops.FlashAttentionFn.apply(*leaves, *kw.values())
    out.backward(torch.from_numpy(dout))
    assert calls == [tuple(kw.values())]
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    want = flash_attention_bwd_ref(tq, tk, tv, out.detach(),
                                   torch.from_numpy(dout), **kw)
    for x, w in zip(leaves, want):
        assert torch.equal(x.grad, w)
    assert all(x.grad.abs().max() > 0 for x in leaves)
