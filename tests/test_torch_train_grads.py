"""The port's ``Model.loss`` and its gradients against
``jax.value_and_grad`` of the JAX package's, for each of the six families
at ``reduced()``.

Both start from the reference's ``Model.init(PRNGKey(0))`` parameters in
its own dtypes (float32: ``Model.init(train=True)``'s), carried across as
leaves that require a gradient, and from each package's
``batch_for_step``, which agree bit for bit (a vlm's image embeddings and
an encdec's frames within a bf16 ulp, cast to float32 compute here from
the same bf16 values: the port's batch is built from the reference's).

Tolerances.  float32 compute: the loss within 1e-5; each gradient leaf
``rtol=1e-4`` with ``atol=1e-5 * max|g|`` of the leaf (the two frameworks
sum the same products in another order: 2.1e-6 of the leaf's max at
most when the tolerance was set).  The dense family in its default bf16
compute: the loss within 0.01 and each gradient leaf within 5 % of its max
(bf16 activations round at other points in the two frameworks, as the LM
serving tests' ``BF16_LOGITS``; 2.6 % at most when set).  ``remat`` on
and off give the same loss and gradients bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.configs.shapes import ShapeConfig as JShape  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.train.data import batch_for_step as jbatch  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.models.factory import cross_entropy  # noqa: E402
from repro_torch.train.optimizer import tree_leaves, tree_map  # noqa: E402

FAMILIES = ["starcoder2-7b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
            "recurrentgemma-2b", "paligemma-3b", "whisper-base"]
SHAPE = JShape("t", "train", 24, 2)


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype):
    jcfg = dataclasses.replace(jget(arch).reduced(), compute_dtype=dtype)
    tcfg = dataclasses.replace(tget(arch).reduced(), compute_dtype=dtype)
    params, _ = jbuild(jcfg).init(jax.random.PRNGKey(0))
    batch = jbatch(jcfg, SHAPE, 1)
    return jcfg, tcfg, params, batch


def _leaves(params):
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
                    .requires_grad_(), jax.tree.map(np.asarray, params))


def _tbatch(batch, cfg):
    out = {}
    for k, v in batch.items():
        a = np.asarray(jnp.asarray(v, jnp.float32) if v.dtype == jnp.bfloat16
                       else v)
        t = torch.from_numpy(np.array(a))
        out[k] = t.to(cfg.cdtype) if k in ("image_embeds", "frames") else t
    return out


def _port(arch, dtype, remat=True):
    jcfg, tcfg, params, batch = _setup(arch, dtype)
    leaves = _leaves(params)
    loss, metrics = tbuild(tcfg).loss(leaves, _tbatch(batch, tcfg),
                                      remat=remat)
    loss.backward()
    return loss, metrics, [x.grad for x in tree_leaves(leaves)]


def _check(arch, dtype, loss_atol, grad_tol):
    jcfg, tcfg, params, batch = _setup(arch, dtype)
    (jl, jm), jg = jax.value_and_grad(jbuild(jcfg).loss, has_aux=True)(
        params, batch)
    tl, tm, tg = _port(arch, dtype)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), float(jl), rtol=0, atol=loss_atol)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0,
                                   atol=loss_atol)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for got, want in zip(tg, jleaves):
        want = np.asarray(want, np.float32)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, **grad_tol(scale))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax_f32(arch):
    _check(arch, "float32", 1e-5,
           lambda scale: dict(rtol=1e-4, atol=1e-5 * scale))


def test_loss_and_grads_match_jax_bf16_dense():
    _check("starcoder2-7b", "bfloat16", 0.01,
           lambda scale: dict(rtol=0, atol=0.05 * scale))


@pytest.mark.parametrize("arch", ["starcoder2-7b", "recurrentgemma-2b",
                                  "whisper-base", "qwen3-moe-30b-a3b"])
def test_remat_is_bitwise_invisible(arch):
    on = _port(arch, "float32", remat=True)
    off = _port(arch, "float32", remat=False)
    assert torch.equal(on[0], off[0])
    for a, b in zip(on[2], off[2]):
        assert torch.equal(a, b)


def test_cross_entropy_masks_and_clamps_the_denominator():
    """Masked positions add nothing; an all-zero mask divides by 1."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(2, 5, 7)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 7, (2, 5)).astype(np.int32))
    mask = torch.tensor([[1, 1, 0, 0, 0], [1, 0, 0, 0, 0]],
                        dtype=torch.float32)
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels[..., None].long())[..., 0]
    want = (nll[0, 0] + nll[0, 1] + nll[1, 0]) / 3
    torch.testing.assert_close(cross_entropy(logits, labels, mask), want)
    assert float(cross_entropy(logits, labels, torch.zeros_like(mask))) == 0


def test_train_init_uses_the_reference_dtypes():
    """``Model.init(train=True)``: every leaf float32 (the serving storage
    keeps block weights in the compute dtype)."""
    for arch in FAMILIES:
        cfg = tget(arch).reduced()
        m = tbuild(cfg)
        train = m.init(torch.Generator().manual_seed(0), "cpu", train=True)
        assert {x.dtype for x in tree_leaves(train)} == {torch.float32}
        serve = m.init(torch.Generator().manual_seed(0), "cpu")
        assert torch.bfloat16 in {x.dtype for x in tree_leaves(serve)}
