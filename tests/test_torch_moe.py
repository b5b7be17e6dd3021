"""The port's MoE layer and moe family (qwen3-moe-30b-a3b, phi3.5-moe) against
the JAX package's.

Inputs are numpy from a seed.  The family tests start from the JAX
package's ``Model.init(PRNGKey(0))`` weights of each ``reduced()`` config
(4 experts, top-2, expert width 64), carried across with
``convert.lm_params_from_arrays``; the norms' scales and biases get seeded
noise first, so that their order of use is tested too.

Tolerances.  float32: ``rtol=atol=1e-5`` on outputs, logits and caches,
as the other families; the routing (which expert, which row of its buffer,
which entries are dropped) is exact.  bfloat16: ``test_torch_lm.py``'s
``BF16_LOGITS`` (``atol=0.08``) and ``BF16_CACHE`` (``atol=0.05``), except
where a routing decision flips.  The two frameworks round bf16 activations
at other points (XLA, compiling the reference's decode loop, keeps some
bf16 intermediates in float32), so two router logits one bf16 ulp apart
may tie or swap: the K-th expert is then another.  A row whose logits miss
``BF16_LOGITS`` must have met such a near tie in that call (its K-th and
(K+1)-th router logits within two bf16 ulps in some layer, on the port's
side), and is held to ``BF16_FLIP_LOGITS`` instead: the flip moves that
token's MLP output by the gate-weighted difference of two experts' outputs.
``MAX_FLIPS`` pins how many rows flip: one in reduced qwen3-moe's first
decode step (row 0, layer 1: experts 1 and 2 at 0.7617 and 0.7656 in the
reference, tied at 0.7656 in the port, which takes the lower; logits 0.26
apart), none in phi3.5-moe.
"""
import dataclasses
import functools
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.serve.engine import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

MOE = ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"]
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_LOGITS = dict(rtol=0, atol=0.08)
BF16_CACHE = dict(rtol=0, atol=0.05)
BF16_FLIP_LOGITS = dict(rtol=0, atol=0.5)
MAX_FLIPS = {"qwen3-moe-30b-a3b": 1, "phi3.5-moe-42b-a6.6b": 0}
MAX_LEN = 24


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _layer_params(rng, D, E, F, gated=True):
    p = {"router": rng.normal(size=(D, E)) / np.sqrt(D),
         "wi": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "wo": rng.normal(size=(E, F, D)) / np.sqrt(F)}
    if gated:
        p["wg"] = rng.normal(size=(E, D, F)) / np.sqrt(D)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _reference_slots(p, x, cfg):
    """The reference's routing, as ``repro.models.moe.apply_moe`` computes
    it (its ``route_one`` is a closure): ``slot [B, S, K]`` in (token,
    choice) order, ``E * C`` for a dropped entry."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = jmoe.moe_capacity(S, cfg)
    logits = jnp.einsum("bsd,de->bse", x, p["router"].astype(x.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, gate_idx = jax.lax.top_k(probs, K)
    out = []
    for idxb in np.asarray(gate_idx):
        eid = jnp.asarray(idxb.reshape(-1))
        order = jnp.argsort(eid, stable=True)
        eid_s = eid[order]
        start = jnp.searchsorted(eid_s, jnp.arange(E))
        pos = jnp.arange(S * K) - start[eid_s]
        slot = jnp.where(pos < C, eid_s * C + pos, E * C)
        out.append(np.asarray(jnp.zeros(S * K, jnp.int32).at[order].set(
            slot)).reshape(S, K))
    return np.stack(out)


def _both(p, x, E, K, cf, gated=True):
    """(reference y, aux, slot; port y, aux, slot) on the same inputs."""
    jcfg = JMoEConfig(num_experts=E, top_k=K, expert_d_ff=p["wi"].shape[2],
                      capacity_factor=cf)
    tcfg = MoEConfig(num_experts=E, top_k=K, expert_d_ff=p["wi"].shape[2],
                     capacity_factor=cf)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    ty, taux = tmoe.apply_moe(tp, tx, tcfg)
    probs = torch.softmax(torch.matmul(tx, tp["router"]), -1)
    tslot = tmoe.route(tmoe.top_k(probs, K)[1],
                       tmoe.moe_capacity(x.shape[1], tcfg), E)
    return (jy, jaux, _reference_slots(jp, jnp.asarray(x), jcfg),
            ty, taux, tslot.numpy())


# ---------------------------------------------------------------------------
# the layer


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0])
def test_moe_capacity_matches_reference(cf):
    for S, E, K in itertools.product((1, 3, 12, 512, 1000, 4096),
                                     (4, 16, 128), (1, 2, 8)):
        jcfg = JMoEConfig(num_experts=E, top_k=K, expert_d_ff=8,
                          capacity_factor=cf)
        tcfg = MoEConfig(num_experts=E, top_k=K, expert_d_ff=8,
                         capacity_factor=cf)
        assert tmoe.moe_capacity(S, tcfg) == jmoe.moe_capacity(S, jcfg)
    qwen = tget("qwen3-moe-30b-a3b").moe
    assert [tmoe.moe_capacity(S, qwen) for S in
            (512, 1000, 2048, 3000, 4096, 1)] == [40, 79, 160, 235, 320, 1]


@pytest.mark.parametrize("gated", [True, False])
def test_apply_moe_drops_the_reference_tokens(gated):
    """A capacity factor of 0.5 drops entries: the dropped ones and every
    kept entry's buffer row equal the reference's exactly, y and the aux
    loss within 1e-5."""
    rng = np.random.default_rng(0)
    B, S, D, E, K = 3, 24, 16, 4, 2
    p = _layer_params(rng, D, E, 8, gated)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    jy, jaux, jslot, ty, taux, tslot = _both(p, x, E, K, 0.5, gated)
    C = jmoe.moe_capacity(S, JMoEConfig(E, K, 8, 0.5))
    dropped = jslot == E * C
    assert 0 < dropped.sum() < dropped.size
    np.testing.assert_array_equal(tslot, jslot)
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    np.testing.assert_allclose(float(taux), float(jaux), **F32)


def test_top_k_ties_go_to_the_lower_expert():
    """Against ``jax.lax.top_k`` on rows full of ties; then a router whose
    columns 1 and 3 are equal, so every token's logits tie there: the layer
    routes to expert 1, as the reference does (expert 3's weights differ,
    so the other choice would change y)."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1], [0.0, 0.5, 0.0, 0.5]],
                     np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    rng = np.random.default_rng(1)
    D, E = 16, 4
    p = _layer_params(rng, D, E, 8)
    p["router"][:, 3] = p["router"][:, 1]
    p["router"][:, [0, 2]] -= 10.0 * np.abs(p["router"][:, [0, 2]])
    x = np.abs(rng.normal(size=(2, 6, D))).astype(np.float32)
    jy, _, jslot, ty, _, tslot = _both(p, x, E, 1, 4.0)
    C = jmoe.moe_capacity(6, JMoEConfig(E, 1, 8, 4.0))
    assert (tslot // C == 1).all()
    np.testing.assert_array_equal(tslot, jslot)
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)


def test_batch_rows_keep_separate_capacities():
    """Row 0 sends every token to one expert, row 1 spreads them: row 0
    drops past C and row 1 drops nothing.  Routing the two rows pooled
    would have ranked row 1's entries behind row 0's."""
    rng = np.random.default_rng(2)
    D, E, K, S = 16, 4, 1, 8
    p = _layer_params(rng, D, E, 8)
    p["router"] = np.eye(D, E, dtype=np.float32) * 20.0
    x = np.zeros((2, S, D), np.float32)
    x[0, :, 0] = 1.0                          # all to expert 0
    x[1, np.arange(S), np.arange(S) % E] = 1.0  # round robin
    jy, _, jslot, ty, _, tslot = _both(p, x, E, K, 1.0)
    C = jmoe.moe_capacity(S, JMoEConfig(E, K, 8, 1.0))
    assert C == 2
    np.testing.assert_array_equal(tslot, jslot)
    assert (tslot[0] == E * C).sum() == S - C
    assert (tslot[1] < E * C).all()
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    gate_idx = torch.from_numpy(jslot // C)          # nothing dropped in 1
    gate_idx[0] = 0
    pooled = tmoe.route(gate_idx.reshape(1, 2 * S, K), C, E)
    assert (pooled == E * C).sum() > (tslot == E * C).sum()


def test_combine_sums_in_ascending_expert_order_in_bf16():
    """bf16: each token's K contributions added in ascending expert id with
    a bf16 rounding after each add, as the reference's scatter-add over the
    expert-sorted entries; y equals the reference bit for bit on inputs
    where every product before the combine rounds alike: small integer
    inputs, ``h = 16 x`` (where bf16 SiLU is the identity), one nonzero
    product per output of ``wi`` and ``wo``."""
    rng = np.random.default_rng(3)
    D, E, K, S = 8, 8, 4, 6
    p = {"router": rng.normal(size=(D, E)),
         "wi": 16 * np.eye(D)[None].repeat(E, 0),
         "wg": np.ones((E, D, D)) / 8,
         "wo": np.eye(D)[None].repeat(E, 0)
         * (1 + np.arange(E))[:, None, None] / 4}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.integers(1, 5, size=(1, S, D)).astype(np.float32)
    jcfg = JMoEConfig(E, K, 8, 2.0)
    tcfg = MoEConfig(E, K, 8, 2.0)
    jy, _ = jmoe.apply_moe({k: jnp.asarray(v, jnp.bfloat16)
                            for k, v in p.items()},
                           jnp.asarray(x, jnp.bfloat16), jcfg)
    ty, _ = tmoe.apply_moe({k: torch.from_numpy(v).bfloat16()
                            for k, v in p.items()},
                           torch.from_numpy(x).bfloat16(), tcfg)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(ty), _np(jy))


# ---------------------------------------------------------------------------
# the family


def _perturb(tree, seed=0):
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
def _setup(name, dtype):
    jcfg = dataclasses.replace(jget(name).reduced(), compute_dtype=dtype)
    tcfg = dataclasses.replace(tget(name).reduced(), compute_dtype=dtype)
    params, _ = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tree = _perturb(jax.tree.map(np.asarray, params))
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            lm_params_from_arrays(tree, tcfg, device="cpu"))


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def _compare_state(jst, tst, tol):
    np.testing.assert_array_equal(_np(tst.kv.length), _np(jst.kv.length))
    np.testing.assert_allclose(_np(tst.kv.k), _np(jst.kv.k), **tol)
    np.testing.assert_allclose(_np(tst.kv.v), _np(jst.kv.v), **tol)


def test_reduced_configs_and_storage_dtypes():
    """Both moe configs are registered with the reference's fields; the
    reduced ones keep 4 experts, top-2, width 64; router and experts are
    stored in the compute dtype, norms in float32."""
    for name in MOE:
        assert dataclasses.asdict(tget(name)) == dataclasses.asdict(
            jget(name))
        r = tget(name).reduced()
        assert (r.moe.num_experts, r.moe.top_k, r.moe.expert_d_ff) == (
            4, 2, 64)
    _, _, _, tp = _setup("qwen3-moe-30b-a3b", "bfloat16")
    moe = tp["stack"]["moe"]
    assert set(moe) == {"router", "wi", "wg", "wo"}
    assert all(t.dtype == torch.bfloat16 for t in moe.values())
    assert moe["wi"].shape == (2, 4, 64, 64)
    assert tp["stack"]["ln2"]["scale"].dtype == torch.float32
    assert "mlp" not in tp["stack"]


def _near_ties(x, router, K):
    """``[B]`` bool: some token of the row has its K-th and (K+1)-th router
    logits within two bf16 ulps of the K-th."""
    top = torch.sort(torch.matmul(x, router.to(x.dtype)).float(), -1,
                     descending=True).values
    ulp = torch.exp2(torch.floor(torch.log2(top[..., K - 1].abs())) - 7)
    return (top[..., K - 1] - top[..., K] <= 2 * ulp).any(-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE)
def test_prefill_and_decode_match_jax(name, dtype, monkeypatch):
    """Prefill's last logits and KV cache, then 4 decode steps' logits and
    the cache after them (both fed the JAX package's greedy tokens).  bf16:
    a row past ``BF16_LOGITS`` must be explained by a near tie (module
    docstring)."""
    jcfg, jp, tcfg, tp = _setup(name, dtype)
    ctol = F32 if dtype == "float32" else BF16_CACHE
    ties, apply = [], tmoe.apply_moe

    def spy(p, x, cfg, act="silu"):
        ties.append(_near_ties(x, p["router"], cfg.top_k))
        return apply(p, x, cfg, act)

    monkeypatch.setattr(tmoe, "apply_moe", spy)
    flips = 0

    def check_logits(tlast, jlast):
        nonlocal flips
        got, want = _np(tlast), _np(jlast)
        near = torch.stack(ties).any(0).numpy()
        ties.clear()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **F32)
            return
        miss = np.abs(got - want).max(-1) > BF16_LOGITS["atol"]
        assert not (miss & ~near).any(), "a miss without a near tie"
        flips += int(miss.sum())
        np.testing.assert_allclose(got[~miss], want[~miss], **BF16_LOGITS)
        np.testing.assert_allclose(got, want, **BF16_FLIP_LOGITS)

    tok = _tokens(1, 2, 12, jcfg.vocab)
    jlast, jst = jbuild(jcfg).prefill(jp, {"tokens": jnp.asarray(tok)},
                                      max_len=MAX_LEN)
    tm = tbuild(tcfg)
    tlast, tst = tm.prefill(tp, {"tokens": torch.from_numpy(tok)},
                            max_len=MAX_LEN)
    assert tlast.dtype == torch.float32
    check_logits(tlast, jlast)
    _compare_state(jst, tst, ctol)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jlast, -1))[:, None]
        jlast, jst = jbuild(jcfg).decode(jp, jnp.asarray(nxt), jst)
        tlast, tst = tm.decode(tp, torch.tensor(nxt), tst)
        check_logits(tlast, jlast)
    _compare_state(jst, tst, ctol)
    assert flips <= MAX_FLIPS[name]


@pytest.mark.parametrize("name", MOE)
def test_chunked_prefill_matches_jax(name, monkeypatch):
    """``prefill(..., chunk=8)`` on a 16-token prompt takes the chunked
    branch in both packages; each chunk's expert capacity is the chunk's
    (C = 5 for 8 tokens, not the prompt's 10)."""
    jcfg, jp, tcfg, tp = _setup(name, "float32")
    tok = _tokens(2, 1, 16, jcfg.vocab)
    seen = []
    route = tmoe.route

    def spy(gate_idx, C, E):
        seen.append((gate_idx.shape[1], C))
        return route(gate_idx, C, E)

    monkeypatch.setattr(tmoe, "route", spy)
    tlast, tst = ttfm.prefill(tp, tcfg, torch.from_numpy(tok),
                              max_len=MAX_LEN, chunk=8)
    jlast, jst = jtfm.prefill(jp, jcfg, jnp.asarray(tok), max_len=MAX_LEN,
                              chunk=8)
    assert seen == [(8, 5)] * 4
    np.testing.assert_allclose(_np(tlast), _np(jlast), **F32)
    _compare_state(jst, tst, F32)


def test_continuous_batching_matches_jax():
    """Three requests through a batch of two on reduced qwen3-moe in
    float32: every token equals the JAX package's batcher's."""
    jcfg, jp, tcfg, tp = _setup("qwen3-moe-30b-a3b", "float32")
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


@pytest.mark.parametrize("name", MOE)
def test_serve_lm_cli_on_cpu(name, capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", name, "--device", "cpu", "--requests", "3",
                      "--batch", "2", "--max-new", "3", "--max-len", "32"])
    assert sorted(out) == [0, 1, 2] and all(len(t) == 3 for t in out.values())
    assert f"[serve] {name} on cpu" in capsys.readouterr().out
