"""The port's dry run and roofline (``launch/dryrun.py``, ``launch/cost.py``,
``launch/roofline.py``, ``launch/mesh.DryMesh``) against the JAX package's
and against real runs of the same steps.

* the analytic counts (``num_params``, ``active_params``, ``model_flops``)
  equal the reference's for every arch x shape;
* every rank's shard of each param, AdamW moment and decode-state leaf at
  the production meshes (16, 16) and (2, 16, 16) equals the reference's
  ``NamedSharding.shard_shape`` (one reference process with 512 forced
  host devices);
* on reduced configs a step on fake CPU tensors counts the FLOPs and gives
  the output shapes of the same step run for real under
  ``FlopCounterMode``; on meta tensors (the card's route) the same,
  attention aside, which B6 counts by its kept pairs;
* a ``DryMesh`` rank counts the calls and bytes, by kind and axis, of the
  same rank of a real ``Mesh`` in one 4-rank gloo world (train, prefill
  and decode of dense and moe), its backward's collectives included;
* B6's custom op: CPU bits unchanged, its fake shapes and its FLOP
  formula against a count by hand;
* the moe aux statistics' static count equals ``torch.bincount``;
* one full-width cell end to end and the roofline of it.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._pytree import tree_leaves  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_mask, flash_attention_gqa_ref)
from repro_torch.launch import cost as cost_lib  # noqa: E402
from repro_torch.launch import dryrun, roofline, steps  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    DryMesh, make_production_mesh, spawn)
from repro_torch.models import moe as moe_lib  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = tbase.list_configs()

#: per-device param elements at (16, 16) and (2, 16, 16), from the
#: reference's own rules on 512 forced host devices
PER_DEVICE_PARAMS = {
    "falcon-mamba-7b": 61_448_448, "mistral-large-123b": 632_427_264,
    "paligemma-3b": 50_631_296, "phi3.5-moe-42b-a6.6b": 187_073_024,
    "qwen2-72b": 435_921_408, "qwen3-moe-30b-a3b": 143_425_664,
    "recurrentgemma-2b": 55_579_040, "stablelm-12b": 108_309_120,
    "starcoder2-7b": 130_863_680, "whisper-base": 2_942_976}


# ---------------------------------------------------------------------------
# (a) the analytic counts


def test_param_counts_and_model_flops_equal_the_reference():
    from repro.configs import base as rbase
    from repro.configs.shapes import SHAPES as RSHAPES
    from repro.launch import roofline as rroof
    assert rbase.list_configs() == ARCHS
    for arch in ARCHS:
        t, r = tbase.get_config(arch), rbase.get_config(arch)
        assert t.num_params() == r.num_params(), arch
        assert t.active_params() == r.active_params(), arch
        for name in SHAPES:
            for chips in (256, 512):
                assert roofline.model_flops(t, SHAPES[name], chips) == \
                    rroof.model_flops(r, RSHAPES[name], chips), (arch, name)


# ---------------------------------------------------------------------------
# (b) every rank's shards at the production meshes

_REFERENCE_SHARDS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=512")
    import json, math, sys
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import base
    from repro.configs.shapes import SHAPES
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import abstract_params, rules_for
    from repro.models import factory

    def path(kp):
        return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                        for k in kp)

    def shards(specs, axes, rules):
        pspecs = rules.tree_specs(axes, specs)
        out = {}
        flat = jax.tree_util.tree_flatten_with_path(specs)[0]
        sp = jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(x, P))
        for (kp, s), spec in zip(flat, sp):
            sh = NamedSharding(rules.mesh, spec).shard_shape(s.shape)
            out[path(kp)] = list(sh)
        return out

    res = {}
    for arch in base.list_configs():
        cfg = base.get_config(arch)
        model = factory.build_model(cfg)
        pspecs, axes = abstract_params(model)
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            rules = rules_for(cfg, mesh)
            one = {"params": shards(pspecs, axes, rules)}
            one["total"] = sum(math.prod(v) for v in one["params"].values())
            for name in ("decode_32k", "long_500k"):
                sh = SHAPES[name]
                st = model.decode_state_specs(sh.global_batch, sh.seq_len)
                ax = factory.state_logical_axes(model, st)
                one[name] = shards(st, ax, rules)
            res[f"{arch}|{int(multi)}"] = one
    json.dump(res, sys.stdout)
""")


@pytest.fixture(scope="module")
def reference_shards():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _REFERENCE_SHARDS], env=env,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return json.loads(out.stdout)


def _named(tree, prefix=()) -> dict:
    """``{"a/b": shape}`` of the tensor leaves of a tree of dicts and
    NamedTuples (None leaves dropped), the reference's key paths."""
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {"/".join(prefix): list(tree.shape)}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = zip(tree._fields, tree)
    return {k: v for name, sub in items
            for k, v in _named(sub, prefix + (str(name),)).items()}


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_every_rank_holds_the_reference_shards(reference_shards, multi):
    meta = torch.device("meta")
    size = 512 if multi else 256
    for arch in ARCHS:
        cfg = tbase.get_config(arch)
        want = reference_shards[f"{arch}|{int(multi)}"]
        assert want["total"] == PER_DEVICE_PARAMS[arch], arch
        for rank in (0, size // 2 + 37, size - 1):
            mesh = make_production_mesh(multi_pod=multi, dry_rank=rank)
            _, (state, _) = steps.build_setup(cfg, SHAPES["train_4k"], mesh,
                                              meta)
            params = _named(state.params)
            assert params == want["params"], (arch, rank)
            assert sum(math.prod(s) for s in params.values()) == \
                PER_DEVICE_PARAMS[arch]
            # AdamW's moments as the params, float32, no master copy (the
            # training params are float32, as the reference's)
            assert _named(state.opt.mu) == params
            assert _named(state.opt.nu) == params
            assert state.opt.master is None
            for name in ("decode_32k", "long_500k"):
                _, (_, _, st) = steps.build_setup(cfg, SHAPES[name], mesh,
                                                  meta)
                assert _named(st) == want[name], (arch, name, rank)


# ---------------------------------------------------------------------------
# (c) the dry run's counts against a real run


def _reduced(arch, **kw):
    return dataclasses.replace(tbase.get_config(arch).reduced(), **kw)


#: (arch, kind, seq, batch) of the one-device comparisons
ONE_DEVICE = [("starcoder2-7b", "train", 32, 2),
              ("starcoder2-7b", "prefill", 32, 2),
              ("starcoder2-7b", "decode", 32, 2),
              ("qwen3-moe-30b-a3b", "train", 32, 2),
              ("qwen3-moe-30b-a3b", "prefill", 32, 2),
              ("qwen3-moe-30b-a3b", "decode", 32, 2),
              ("recurrentgemma-2b", "prefill", 32, 2),
              ("falcon-mamba-7b", "train", 16, 2),
              ("paligemma-3b", "prefill", 32, 2),
              ("whisper-base", "prefill", 16, 2)]


def _real_run(cfg, shape, mesh=None, attention=None):
    """One real CPU step (inputs drawn, seeded) under FlopCounterMode:
    (FLOPs by op, output shapes); ``attention`` collects the unmasked
    FLOPs of each plain attention call."""
    run, inputs = steps.build_setup(cfg, shape, mesh, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    for t in tree_leaves(inputs):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            t.copy_(0.02 * torch.randn(t.shape, generator=gen))
    ref = flash_ops.flash_attention_gqa_ref

    def counted(q, k, v, **kw):
        attention.append(4 * q.shape[0] * q.shape[2] * q.shape[3]
                         * q.shape[1] * k.shape[1])
        return ref(q, k, v, **kw)
    if attention is not None:
        flash_ops.flash_attention_gqa_ref = counted
    try:
        with FlopCounterMode(display=False) as fc:
            out = run()
    finally:
        flash_ops.flash_attention_gqa_ref = ref
    flops = {str(k): int(v) for k, v in fc.get_flop_counts()["Global"].items()}
    return flops, [tuple(t.shape) for t in tree_leaves(out)
                   if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("arch,kind,seq,batch", ONE_DEVICE)
def test_dry_step_counts_what_a_real_step_does(arch, kind, seq, batch):
    cfg = _reduced(arch)
    shape = ShapeConfig("s", kind, seq, batch)
    attention = []
    flops, shapes = _real_run(cfg, shape, attention=attention)
    fake = dryrun.dry_step(cfg, shape, device="cpu")
    assert fake["flops_by_op"] == flops
    assert fake["out_shapes"] == shapes
    assert fake["launches"] == {}
    if kind == "train":
        return          # the card's backward is another function (B6's)
    # the card's route: B6 counts its kept pairs where the plain version
    # counted every pair; everything else the same
    card = dryrun.dry_step(cfg, shape)
    assert card["out_shapes"] == shapes
    b6 = card["flops_by_op"].pop("repro_torch.flash_attention", 0)
    assert card["launches"].get("flash_attention", 0) == len(attention)
    assert 0 < b6 <= sum(attention) or not attention
    rest = dict(flops)
    rest["aten.bmm"] = rest.get("aten.bmm", 0) - sum(attention)
    assert {k: v for k, v in card["flops_by_op"].items() if v} == \
        {k: v for k, v in rest.items() if v}


#: what fake CUDA tensors and meta tensors count exactly alike; bytes and
#: ops differ by a few copies (``matmul`` folds a batch into ``mm`` or
#: copies it for ``bmm`` by the strides of size-1 dims, which the two lay
#: out differently: the same FLOPs), within FAKE_RTOL (the card: 1.3 % of
#: a reduced decode step's bytes, 0.7 % of a prefill's ops)
EXACT = ("flops", "launches", "collectives", "peak_bytes")
FAKE_RTOL = {"bytes": 0.05, "ops": 0.05}


def _same_counts(a: dict, b: dict) -> None:
    for k in EXACT:
        assert a[k] == b[k], k
    for k, tol in FAKE_RTOL.items():
        assert abs(a[k] - b[k]) <= tol * max(a[k], b[k]), (k, a[k], b[k])


@pytest.mark.cuda
def test_dry_run_on_fake_cuda_tensors_equals_meta():
    """With a card (a CUDA build: a fake CUDA tensor's indexing and
    backward need one), the meta stand-in counts what fake CUDA tensors
    count: reduced qwen3-moe's three steps on a (2, 2) rank and one
    full-width cell."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: fake CUDA tensors need a CUDA "
                    "build")
    cfg = _reduced("qwen3-moe-30b-a3b")
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("s", kind, 32, 4)
        recs = [dryrun.dry_step(cfg, shape, DryMesh((2, 2), rank=3),
                                device=device) for device in ("meta", "cuda")]
        _same_counts(*recs)
        assert recs[0]["out_shapes"] == recs[1]["out_shapes"]
        assert recs[0]["launches"].get("flash_attention", 0) > 0 or \
            kind == "decode"
    cell = dryrun.run_cell("whisper-base", "prefill_32k", "single",
                           write=False)
    assert cell["status"] == "OK"
    for rank, meta in zip(cell["ranks"], cell["per_rank"]):
        fake = dryrun.dry_step(tbase.get_config("whisper-base"),
                               SHAPES["prefill_32k"],
                               make_production_mesh(dry_rank=rank),
                               device="cuda")
        assert fake["device"] == "cuda"
        _same_counts(meta, fake)


def test_fake_cuda_tensors_need_a_cuda_build():
    if torch.backends.cuda.is_built():
        pytest.skip("a CUDA build runs fake CUDA tensors")
    with pytest.raises(ValueError, match="CUDA build"):
        dryrun.dry_step(_reduced("starcoder2-7b"),
                        ShapeConfig("s", "train", 16, 2), device="cuda")


def test_host_read_inside_a_step_fails_naming_the_op():
    dev = torch.device("meta")
    with cost_lib.StepCost(dev):
        x = torch.zeros(4, device=dev)
        with pytest.raises(cost_lib.HostRead, match="_local_scalar_dense"):
            float(x.sum())
        with pytest.raises(cost_lib.HostRead, match="bincount"):
            torch.bincount(x.long())
        with pytest.raises(cost_lib.HostRead, match="index.Tensor"):
            x[x > 0]
        x[torch.zeros(2, dtype=torch.long, device=dev)]    # static: fine


def test_step_cost_counts_bytes_flops_and_memory():
    dev = torch.device("meta")
    with cost_lib.StepCost(dev) as c:
        a = torch.empty(64, 32, dtype=torch.bfloat16, device=dev)
        b = torch.empty(32, 16, dtype=torch.float32, device=dev)
        c.reset_peak()
        c.counting = True
        y = a @ b.to(torch.bfloat16)          # _to_copy, mm
        z = y.t().float()                     # a view (nothing), _to_copy
        del y
        c.counting = False
    s = c.summary()
    assert s["flops"] == {"tensor": 2 * 64 * 32 * 16}
    assert s["ops"] == 3
    assert s["bytes"] == (32 * 16 * (4 + 2) + (64 * 32 + 32 * 16 + 64 * 16)
                          * 2 + 64 * 16 * (2 + 4))
    # rounded to 512-byte blocks: the cast b dies after the product, so
    # the peak is a, b, y and z
    assert s["peak_bytes"] == 4096 + 2048 + 2048 + 4096
    del z


# ---------------------------------------------------------------------------
# (d) a DryMesh rank against a real Mesh's

WORLD_CASES = [
    {"arch": "starcoder2-7b", "shape": ("train", 16, 4), "mesh": (2, 2)},
    {"arch": "starcoder2-7b", "shape": ("prefill", 16, 4), "mesh": (2, 2)},
    {"arch": "starcoder2-7b", "shape": ("decode", 16, 4), "mesh": (2, 2)},
    {"arch": "qwen3-moe-30b-a3b", "shape": ("train", 16, 4),
     "mesh": (2, 2)},
    {"arch": "qwen3-moe-30b-a3b", "shape": ("decode", 16, 4),
     "mesh": (2, 2)},
    {"arch": "starcoder2-7b", "shape": ("train", 16, 4), "mesh": (1, 4)},
]


def _matmuls(flops: dict) -> dict:
    """FLOPs by op with ``mm`` and ``bmm`` as one: ``matmul`` folds a
    batch into ``mm`` or not by the strides of size-1 dims, which a fake
    tensor may lay out differently from the real one (the same
    products)."""
    out = dict(flops)
    out["mm+bmm"] = out.pop("aten.mm", 0) + out.pop("aten.bmm", 0)
    return out


@pytest.fixture(scope="module")
def world_counts():
    from repro_torch.launch.distributed import run_count_cases
    return spawn(run_count_cases, 4, "gloo", (WORLD_CASES,), timeout_s=300)


@pytest.mark.parametrize("i", range(len(WORLD_CASES)),
                         ids=[f"{c['arch']}-{c['shape'][0]}-"
                              f"{c['mesh'][0]}x{c['mesh'][1]}"
                              for c in WORLD_CASES])
def test_dry_mesh_counts_what_a_real_mesh_does(world_counts, i):
    case = WORLD_CASES[i]
    cfg = _reduced(case["arch"])
    kind, seq, batch = case["shape"]
    shape = ShapeConfig(f"{kind}_{seq}x{batch}", kind, seq, batch)
    calls = set()
    for rank, real in enumerate(world_counts):
        real = real[i]
        mesh = DryMesh(case["mesh"], rank=rank)
        assert mesh.coords == real["coords"]
        # the card's route on meta tensors: B6 counts other FLOPs than
        # the plain attention the world ran, the collectives are the same
        dry = dryrun.dry_step(cfg, shape, mesh)
        assert dry["collectives"] == real["collectives"], rank
        assert dry["out_shapes"] == [tuple(s) for s in real["out_shapes"]]
        if kind == "decode":         # no attention kernel: the same FLOPs
            assert _matmuls(dry["flops_by_op"]) == _matmuls(real["flops"])
        calls.add(dry["collectives"]["calls"])
    assert min(calls) > 0


# ---------------------------------------------------------------------------
# (e) B6's custom op

MASKS = [dict(causal=True), dict(causal=False),
         dict(causal=True, window=5), dict(causal=True, q_offset=7),
         dict(causal=True, prefix_len=6), dict(causal=False, kv_len=11),
         dict(causal=True, window=4, q_offset=9, kv_len=20, prefix_len=3),
         dict(causal=True, q_offset=-3)]


@pytest.mark.parametrize("masks", MASKS, ids=[str(m) for m in MASKS])
def test_b6_on_the_cpu_is_bitwise_its_plain_version(masks):
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(2, 13, 4, 16, generator=gen)
    k = torch.randn(2, 22, 2, 16, generator=gen)
    v = torch.randn(2, 22, 2, 16, generator=gen)
    for dt in (torch.float32, torch.bfloat16):
        got = flash_ops.flash_attention(q.to(dt), k.to(dt), v.to(dt), **masks)
        want = flash_attention_gqa_ref(q.to(dt), k.to(dt), v.to(dt), **masks)
        assert torch.equal(got, want)


@pytest.mark.parametrize("masks", MASKS, ids=[str(m) for m in MASKS])
def test_b6_fake_shape_and_flop_formula(masks):
    from torch._subclasses.fake_tensor import FakeTensorMode
    B, Sq, Skv, H, Hkv, hd = 2, 13, 22, 4, 2, 16
    kept = int(attention_mask(Sq, Skv, **masks).sum())
    by_hand = sum(1 for i in range(Sq) for j in range(Skv)
                  if _sees(i, j, Skv, **masks))
    assert kept == by_hand
    assert flash_ops.attention_pairs(Sq, Skv, **masks) == by_hand
    for ctx, dev in ((FakeTensorMode(), "cuda"), (None, "meta")):
        with ctx if ctx is not None else torch.no_grad():
            q = torch.empty(B, Sq, H, hd, dtype=torch.bfloat16, device=dev)
            k = torch.empty(B, Skv, Hkv, hd, dtype=torch.bfloat16,
                            device=dev)
            with FlopCounterMode(display=False) as fc:
                o = flash_ops.flash_attention(q, k, k, **masks)
            assert o.shape == q.shape and o.dtype == q.dtype
            assert o.device.type == dev
            assert fc.get_total_flops() == 4 * B * H * hd * by_hand


def _sees(i, j, skv, causal=True, window=None, q_offset=0, kv_len=None,
          prefix_len=None):
    p = q_offset + i
    ok = (j <= p or not causal) and (window is None or j > p - window)
    ok = ok or (prefix_len is not None and j < prefix_len)
    return ok and j < (skv if kv_len is None else kv_len)


def test_b6_gradient_runs_on_meta_tensors():
    dev = torch.device("meta")
    q = torch.empty(1, 8, 2, 16, device=dev, requires_grad=True)
    k = torch.empty(1, 8, 1, 16, device=dev, requires_grad=True)
    flash_ops.flash_attention(q, k, k).sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


# ---------------------------------------------------------------------------
# the moe aux statistics


def test_pick_counts_equal_bincount_bitwise():
    gen = torch.Generator().manual_seed(3)
    for E, shape in ((4, (2, 7, 2)), (128, (3, 64, 8)), (16, (1, 1, 2))):
        idx = torch.randint(0, E, shape, generator=gen)
        want = torch.bincount(idx.reshape(-1), minlength=E)
        got = moe_lib.pick_counts(idx, E)
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert torch.equal(got.float(), want.float())


# ---------------------------------------------------------------------------
# (f) one full-width cell end to end


def test_full_width_cell_and_its_roofline(tmp_path, monkeypatch):
    monkeypatch.setenv("DRYRUN_OUT", str(tmp_path))
    rec = dryrun.run_cell("whisper-base", "decode_32k", "single",
                          force=True)
    assert rec["status"] == "OK", rec.get("error")
    assert rec["ranks"] == [0, 255] and rec["chips"] == 256
    assert 0 < rec["peak_bytes"] < roofline.HBM_BYTES
    assert rec["flops_total"] > 0 and rec["bytes"] > 0
    # the decode step's collectives: the embed's sum, the unembed's
    # gather, per decoder layer the FSDP gathers, the q/k/v gather, the
    # partial softmaxes' gather and the row-parallel sums
    kinds = rec["collectives"]["by_kind"]
    assert set(kinds) <= {"all_gather", "all_reduce"}
    assert set(rec["collectives"]["by_axis"]) == {"data", "model"}
    assert os.path.exists(tmp_path / "whisper-base__decode_32k__single.json")
    a = roofline.analyze_record(rec)
    assert a["dominant"] in ("compute", "memory", "collective")
    assert a["bound_s"] == max(a["compute_s"], a["memory_s"],
                               a["collective_s"])
    # every axis of the production mesh spans nodes: InfiniBand
    assert not roofline.axis_in_node((16, 16), ("data", "model"), "model")
    assert roofline.axis_in_node((1, 4), ("data", "model"), "model")
    assert roofline.axis_in_node((2, 4), ("data", "model"), "data")
    assert not roofline.axis_in_node((4, 4), ("data", "model"), "data")
    skip = dryrun.run_cell("starcoder2-7b", "long_500k", "multi",
                           force=True)
    assert skip["status"] == "SKIP"
    assert dryrun.summary_line([rec, skip]) == \
        "== dry-run: 1 OK, 1 SKIP, 0 FAIL of 2 cells =="


def test_ranks_records_merge_when_their_keys_differ():
    """The larger of two ranks' records keeps a key that only one has
    (ranks that enter different collectives), either way round."""
    a = {"calls": 3, "bytes": 40,
         "by_kind": {"all_reduce": {"calls": 3, "bytes": 40}},
         "by_axis": {"model": {"calls": 3, "bytes": 40}}}
    b = {"calls": 2, "bytes": 64,
         "by_kind": {"all_gather": {"calls": 2, "bytes": 64}},
         "by_axis": {"data": {"calls": 2, "bytes": 64}}}
    want = {"calls": 3, "bytes": 64,
            "by_kind": {"all_gather": {"calls": 2, "bytes": 64},
                        "all_reduce": {"calls": 3, "bytes": 40}},
            "by_axis": {"data": {"calls": 2, "bytes": 64},
                        "model": {"calls": 3, "bytes": 40}}}
    assert dryrun._larger(a, b) == want
    assert dryrun._larger(b, a) == want
    t = roofline.terms({"tensor": 1e12}, 1e9, want["by_axis"], (16, 16),
                       ("data", "model"))
    assert t["collective"] > 0


def test_the_command_lines(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DRYRUN_OUT", str(tmp_path / "cells"))
    argv = ["--arch", "whisper-base", "--shape", "decode_32k", "--mesh",
            "both", "--rank", "3"]
    assert dryrun.main(argv) == 0
    out = capsys.readouterr().out
    assert "== dry-run: 2 OK, 0 SKIP, 0 FAIL of 2 cells ==" in out
    rec = json.loads((tmp_path / "cells" /
                      "whisper-base__decode_32k__multi.json").read_text())
    assert rec["ranks"] == [3] and rec["per_rank"][0]["coords"] == {
        "pod": 0, "data": 0, "model": 3}
    assert roofline.main(["--results", str(tmp_path / "cells"),
                          "--markdown"]) == 0
    table = capsys.readouterr().out.splitlines()
    assert len(table) == 3 and table[2].startswith(
        "| whisper-base | decode_32k | OK, ")
    assert json.loads((tmp_path / "roofline_torch.json").read_text())[0][
        "dominant"] in ("compute", "memory", "collective")


def test_dry_mesh_collectives_shapes_and_adjoints():
    m = DryMesh((2, 16, 16), ("pod", "data", "model"), rank=511)
    assert m.coords == {"pod": 1, "data": 15, "model": 15}
    x = torch.empty(3, 4, device="meta", requires_grad=True)
    assert m.all_gather(x, "model").shape == (16, 3, 4)
    assert m.all_reduce_sum(x, "data").shape == (3, 4)
    assert m.exchange(x, "model", (1, 2) + (0,) * 14,
                      (5,) * 16).shape == (80, 4)
    y = m.all_gather(x, "data", grad="sum")
    y.sum().backward()                       # the adjoint: a reduce-scatter
    assert x.grad.shape == (3, 4)
    c = m.collectives()
    assert c["by_kind"]["reduce_scatter"] == {"calls": 1,
                                              "bytes": 16 * 48}
    assert c["by_kind"]["all_gather"] == {"calls": 2, "bytes": 2 * 48}
    assert c["calls"] == m.calls == 5
    m.reset_counts()
    assert m.calls == 0 and m.collectives()["bytes"] == 0
    with pytest.raises(ValueError):
        DryMesh((16, 16), rank=256)
