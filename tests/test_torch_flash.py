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
result once, but the float32 results differ in the last bits).
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
    flash_attention_gqa_ref, flash_attention_ref)
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
