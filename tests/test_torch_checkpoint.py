"""The port's checkpoints and fault-tolerant loop: integrity, the atomic
commit, bitwise resume (the counterparts of ``tests/test_checkpoint.py``),
and the on-disk format shared with the JAX package's."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train.data import batch_for_step  # noqa: E402
from repro_torch.train.loop import LoopConfig, run_loop  # noqa: E402
from repro_torch.train.optimizer import AdamW, constant, tree_leaves  # noqa
from repro_torch.train.train_step import (init_train_state,  # noqa: E402
                                          make_train_step)

CFG = get_config("starcoder2-7b").reduced()
SHAPE = ShapeConfig("t", "train", 32, 4)


def _state():
    return init_train_state(build_model(CFG),
                            torch.Generator().manual_seed(0), AdamW(),
                            device="cpu")


def test_roundtrip(tmp_path):
    state = _state()
    ck.save(str(tmp_path), 3, state, extra={"note": "hi"})
    got, step, extra = ck.restore(str(tmp_path), target=state)
    assert step == 3 and extra == {"note": "hi"}
    assert type(got) is type(state) and type(got.opt) is type(state.opt)
    a, b = tree_leaves(state), tree_leaves(got)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_crc_detects_corruption(tmp_path):
    state = _state()
    path = ck.save(str(tmp_path), 1, state)
    files = [f for f in os.listdir(path) if f.endswith(".npy")]
    victim = os.path.join(path, sorted(files)[0])
    with open(victim, "r+b") as f:
        f.seek(-4, 2)
        f.write(b"\x00\x01\x02\x03")
    with pytest.raises(IOError, match="CRC"):
        ck.restore(str(tmp_path), target=state)


def test_interrupted_write_leaves_previous_checkpoint(tmp_path):
    state = _state()
    ck.save(str(tmp_path), 1, state)
    tmp_dir = os.path.join(str(tmp_path), "tmp.2")
    os.makedirs(tmp_dir)
    with open(os.path.join(tmp_dir, "partial.npy"), "wb") as f:
        f.write(b"garbage")
    assert ck.latest_step(str(tmp_path)) == 1
    _, step, _ = ck.restore(str(tmp_path), target=state)
    assert step == 1


def test_missing_leaf_raises(tmp_path):
    state = _state()
    ck.save(str(tmp_path), 1, {"only": torch.zeros(3)})
    with pytest.raises(KeyError):
        ck.restore(str(tmp_path), target=state)


def test_async_checkpointer_gc(tmp_path):
    acp = ck.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = {"w": torch.arange(8)}
    for s in (1, 2, 3, 4):
        acp.save(s, tree)
        acp.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]


def test_async_save_is_a_snapshot(tmp_path):
    """The tree is updated in place as soon as ``save`` returns, as the
    train step updates its state: the checkpoint holds the values from
    before the update, float32 and bf16 alike."""
    acp = ck.AsyncCheckpointer(str(tmp_path))
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(1 << 22, generator=g),
            "b": torch.randn(1 << 20, generator=g).bfloat16()}
    want = {k: v.clone() for k, v in tree.items()}
    acp.save(1, tree)
    for v in tree.values():
        v.add_(1)
    acp.wait()
    got, _, _ = ck.restore(str(tmp_path), target=tree)
    for k in tree:
        assert torch.equal(got[k], want[k]), k


def test_bitwise_resume_after_failure(tmp_path):
    """A run killed at step 6 (checkpoint at 4) and restarted ends with the
    uninterrupted run's parameters, moments and loss history, bit for
    bit."""
    model = build_model(CFG)
    opt = AdamW()
    data = lambda s: batch_for_step(CFG, SHAPE, s, device="cpu")  # noqa
    ts = make_train_step(model, opt, constant(3e-3))
    full, fstats = run_loop(ts, _state(), data,
                            LoopConfig(n_steps=8, ckpt_dir=None,
                                       log_every=1), log=lambda *a: None)

    class Boom(Exception):
        pass

    def fault(step):
        if step == 6:
            raise Boom()

    lc = LoopConfig(n_steps=8, ckpt_every=4, ckpt_dir=str(tmp_path),
                    log_every=1)
    with pytest.raises(Boom):
        run_loop(ts, _state(), data, lc, log=lambda *a: None,
                 fault_hook=fault)
    assert ck.latest_step(str(tmp_path)) == 4
    resumed, stats = run_loop(ts, _state(), data, lc, log=lambda *a: None)
    assert stats.restored_step == 4 and stats.steps_run == 4
    assert [h["loss"] for h in stats.history] == \
        [h["loss"] for h in fstats.history[4:]]
    for a, b in zip(tree_leaves(full), tree_leaves(resumed)):
        assert torch.equal(a, b)
    assert int(resumed.step) == 8


def test_resharding_restore_dtype_cast(tmp_path):
    """A checkpoint restores onto a target with another leaf dtype; a bf16
    leaf round-trips through its 16-bit words."""
    tree = {"w": torch.arange(16, dtype=torch.float32) / 3}
    ck.save(str(tmp_path), 1, tree)
    target = {"w": torch.empty(16, dtype=torch.bfloat16)}
    got, _, _ = ck.restore(str(tmp_path), target=target)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], tree["w"].to(torch.bfloat16))
    ck.save(str(tmp_path), 2, got)
    back, _, _ = ck.restore(str(tmp_path), target=target)
    assert torch.equal(back["w"], got["w"])


def test_on_disk_format_is_the_references(tmp_path):
    """Key paths, file names and manifest fields as the JAX package writes
    them, so a reference checkpoint restores into the port."""
    jax = pytest.importorskip("jax")
    from repro.configs.base import get_config as jget
    from repro.models.factory import build_model as jbuild
    from repro.train import checkpoint as jck
    from repro.train.optimizer import AdamW as JAdamW
    from repro.train.train_step import init_train_state as jinit
    jstate = jinit(jbuild(jget("starcoder2-7b").reduced()),
                   jax.random.PRNGKey(0), JAdamW())
    jck.save(str(tmp_path / "ref"), 2, jstate)
    state = _state()
    ck.save(str(tmp_path / "port"), 2, state)
    man = [json.load(open(tmp_path / d / "step_2" / "manifest.json"))
           for d in ("ref", "port")]
    assert sorted(man[0]["leaves"]) == sorted(man[1]["leaves"])
    for k, meta in man[0]["leaves"].items():
        mine = man[1]["leaves"][k]
        assert (mine["file"], mine["shape"], mine["dtype"]) == \
            (meta["file"], meta["shape"], meta["dtype"])
    got, step, _ = ck.restore(str(tmp_path / "ref"), target=state)
    assert step == 2
    for a, b in zip(tree_leaves(got.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
