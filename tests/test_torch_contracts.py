"""The Hopper kernels' static contracts (``kernels/contract.py``) and the
passes that check them (``analysis/kernel_passes.py``), on the CPU.

Every package of ``KERNEL_PACKAGES`` publishes ``CONTRACTS``; the passes
report no error on the tree and catch each seeded fault (a tile that does
not divide, an output the grid covers twice, shared memory past a thread
block's 232,448 B, too many threads or too large a cluster, a fused
contract that is not the planner's model, a stale ``wired`` claim on a
copied tree, a dead kernel with no note); a counter-only import is no
dispatch.  The Python mirrors of the C++ shared-memory counts read the
constants the sources declare.  The built libraries' own counts are held
against the contracts on the card (``chip_smoke.py``).
"""
import dataclasses
import re
import shutil

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import PassContext, repo_root  # noqa: E402
from repro_torch.analysis import kernel_passes as kp  # noqa: E402
from repro_torch.fpp.planner import MemoryModel  # noqa: E402
from repro_torch.kernels import contract  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.fused_visit import ops as fused_ops  # noqa: E402
from repro_torch.kernels.minplus import ops as minplus_ops  # noqa: E402
from repro_torch.kernels.ppr_push import ops as push_ops  # noqa: E402

CSRC = repo_root() / "src" / "repro_torch" / "kernels" / "csrc"
MEM = MemoryModel()


def _codes(findings, severity="error"):
    return sorted(f.code for f in findings if f.severity == severity)


def _contract(name):
    return next(c for c in contract.all_contracts() if c.name == name)


@pytest.mark.parametrize("pkg", contract.KERNEL_PACKAGES)
def test_every_package_publishes_contracts(pkg):
    """Each package's ops module declares at least one contract, of its
    own package and module, with a CUDA kernel's name."""
    import importlib
    ops = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
    assert ops.CONTRACTS
    for c in ops.CONTRACTS:
        assert c.name == pkg and c.module == ops.__name__
        assert re.search(rf"\b{re.escape(c.kernel.split('<')[0])}\b",
                         (CSRC / f"{pkg}.cu").read_text()), c.kernel


def test_passes_find_no_error_on_the_tree():
    """Both passes over the tree: no error; B3 and B4 are dead with their
    ruling, every other package and ``core/randomwalk`` dispatched."""
    findings = kp.run(PassContext())
    assert _codes(findings) == []
    dead = {f.location.rsplit("/", 1)[-1] for f in findings
            if f.code == "dead-kernel"}
    assert dead == {"frontier", "ppr_push"}
    wired = {f.location for f in findings if f.code == "wired"}
    assert wired == {f"src/repro_torch/kernels/{p}" for p in
                     ("minplus", "fused_visit", "flash_attention",
                      "threefry")} | {"src/repro_torch/core/randomwalk.py"}


@pytest.mark.parametrize("fault,code", [
    ("tile", "tile-divisibility"), ("twice", "grid-coverage"),
    ("accum", "grid-coverage"), ("smem", "smem-overflow"),
    ("threads", "threads"), ("cluster", "cluster"), ("ctas", "ctas"),
    ("model", "model-overflow"), ("fused", "model-mismatch")])
def test_contract_pass_catches_a_seeded_fault(fault, code):
    """One bad field of a good contract is one error of its code."""
    c = _contract("fused_visit" if fault in ("accum", "fused") else
                  "flash_attention" if fault == "ctas" else "minplus")
    t = c.out_tiles[0]
    bad = {
        "tile": lambda: dict(out_tiles=(dataclasses.replace(
            t, block=(1, 48, 32)),)),
        "twice": lambda: dict(grid=(c.grid[0] * 2,) + c.grid[1:]),
        "accum": lambda: dict(out_tiles=c.out_tiles[:-1] + (
            dataclasses.replace(c.out_tiles[-1], block=(1,)),)),
        "smem": lambda: dict(smem_bytes=MEM.smem_bytes + 16),
        "threads": lambda: dict(threads=2048),
        "cluster": lambda: dict(cluster=16),
        "ctas": lambda: dict(ctas=c.grid_size() + 1),
        "model": lambda: dict(smem_bytes=MEM.working_set(
            c.block_size, c.num_queries) + 4),
        "fused": lambda: dict(smem_bytes=c.smem_bytes + 16),
    }[fault]()
    assert _codes(kp.check_contract(c, MEM)) == []
    assert _codes(kp.check_contract(dataclasses.replace(c, **bad),
                                    MEM)) == [code]


def test_fused_contract_is_the_planners_model():
    """The fused contracts' bytes are ``fused_visit/ops.smem_bytes`` (the
    launch's) and ``MemoryModel.fused_working_set`` (the planner's)."""
    for c in fused_ops.CONTRACTS:
        assert c.smem_bytes == fused_ops.smem_bytes(
            c.num_planes, c.num_queries, c.block_size) == \
            MEM.fused_working_set(c.block_size, c.num_queries, c.num_planes)
        assert c.cluster == fused_ops.cluster_size(c.num_queries)


def _constants(src):
    text = (CSRC / src).read_text()
    return {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", text)}


def test_mirrors_read_the_sources_constants():
    """The Python mirrors of the C++ counts use the constants the sources
    declare, and give the numbers the sources' comments state."""
    mp = _constants("minplus.cu")
    assert (minplus_ops._COLS, minplus_ops._THREADS, minplus_ops._SEG_CAP) \
        == (mp["kCols"], mp["kCols"] * mp["kWarps"], mp["kSegCap"])
    assert minplus_ops._ROWS == mp["kWarps"] * mp["kWarpRows"]
    pp = _constants("ppr_push.cu")
    assert (push_ops._THREADS, push_ops._ROWS) == (pp["kThreads"],
                                                  pp["kRows"])
    fa = _constants("flash_attention.cu")
    assert (flash_ops._QT, flash_ops._KC, flash_ops._THREADS,
            flash_ops._THREADS_WIDE, flash_ops._MAX_SPLITS,
            flash_ops._TC_ROWS, flash_ops._TC_THREADS) == (
        fa["kQT"], fa["kKC"], fa["kThreads"], fa["kThreadsWide"],
        fa["kMaxSplits"], fa["kTcRows"], fa["kTcThreads"])
    # csrc/flash_attention.cu, F32Shape: "114,688 B at hd 128 (two blocks
    # an SM), 212,992 B at hd 256"; the tensor-core kernel's hd 256 ring:
    # "64 + 4 x 32 KB"
    assert flash_ops.fp32_smem_bytes(128) == 114_688
    assert flash_ops.fp32_smem_bytes(256) == 212_992
    assert flash_ops.tc_smem_bytes(256) == (64 + 4 * 32) * 1024 + 128 + 1024
    # three stages where they fit beside the q tile (hd <= 128), else two
    assert flash_ops.tc_smem_bytes(128) == (32 + 6 * 32) * 1024 + 1152
    assert minplus_ops.smem_bytes(True, 128, 10) == 4 * (8 * 128 + 32 * 2)


#: (B, Sq, Skv, H, hd) of every float32 launch phase 6 times (PERF.md's
#: rows 6b, 6d-6k): starcoder2-7b, recurrentgemma-2b, qwen3-moe-30b-a3b,
#: paligemma-3b, whisper-base's encoder, one rank's share under tp4 (6h),
#: train tp2 (6i), ep4 (6j) and "seq" (6k)
_F32_TIMED = ((1, 4096, 4096, 36, 128), (1, 4096, 4096, 10, 256),
              (1, 4096, 4096, 32, 128), (1, 4096, 4096, 8, 256),
              (1, 1536, 1536, 8, 64), (1, 2048, 2048, 9, 128),
              (1, 1024, 1024, 18, 128), (1, 4096, 4096, 8, 128),
              (1, 512, 2048, 10, 256))


@pytest.mark.parametrize("shape", sorted(
    {(B, Sq, Skv, H, hd) for hd, B, Sq, Skv, H, _ in flash_ops._SHAPES}
    | set(_F32_TIMED)), ids=str)
def test_float32_launch_shape_fills_the_card(shape):
    """The host's choice for a float32 launch (``fp32_splits``) at every
    float32 contract's shape and phase 6's timed ones: a grid of at least
    one block for each block the SMs hold at once, a cluster of at most 8
    whose splits each keep two or more 64-key chunks and divide the q
    tile's rows, shared memory within one block's 232,448 B (and the SM's
    for the blocks it holds)."""
    B, Sq, Skv, H, hd = shape
    rows, splits = flash_ops._QT, flash_ops.fp32_splits(B, Sq, Skv, H, hd)
    ctas = -(-Sq // rows) * splits * H * B
    assert ctas >= contract.H100_SMS * flash_ops.fp32_blocks_per_sm(hd)
    assert 1 <= splits <= 8 and -(-Skv // flash_ops._KC) >= 2 * splits
    assert rows % splits == 0
    assert flash_ops.fp32_smem_bytes(hd) <= 232_448
    assert flash_ops.fp32_blocks_per_sm(hd) * (
        flash_ops.fp32_smem_bytes(hd) + 1024) <= 233_472


def _copy_tree(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(repo_root() / "src" / "repro_torch",
                    root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    return root


def test_reachability_catches_a_stale_wired_claim(tmp_path):
    """On a copied tree without ``models/attention.py`` (the flash
    kernel's one dispatcher) the flash contracts' ``wired=True`` is
    stale."""
    root = _copy_tree(tmp_path)
    (root / "src/repro_torch/models/attention.py").unlink()
    findings = kp.check_reachability(PassContext(root))
    errors = [f for f in findings if f.severity == "error"]
    assert [(f.code, f.location) for f in errors] == [
        ("stale-wired-claim", "src/repro_torch/kernels/flash_attention")]


def test_reachability_catches_a_stale_dead_claim(tmp_path):
    """A module that launches B3 makes its ``wired=False`` stale; one that
    only reads and resets its counter (as ``launch/distributed.py``)
    does not."""
    root = _copy_tree(tmp_path)
    counters = root / "src/repro_torch/launch/counters_only.py"
    counters.write_text("from repro_torch.kernels.frontier import ops\n"
                        "ops.reset_launches()\nN = ops.LAUNCHES\n")
    assert _codes(kp.check_reachability(PassContext(root))) == []
    (root / "src/repro_torch/launch/uses_frontier.py").write_text(
        "from repro_torch.kernels.frontier.ops import frontier\n")
    findings = kp.check_reachability(PassContext(root))
    errors = [f for f in findings if f.severity == "error"]
    assert [(f.code, f.location) for f in errors] == [
        ("stale-dead-claim", "src/repro_torch/kernels/frontier")]
    assert "uses_frontier.py" in errors[0].message


def test_reachability_catches_a_dead_kernel_without_a_note():
    """``wired=False`` with no note is an error; with one, allowlisted."""
    contracts = [dataclasses.replace(c, note="") if c.name == "frontier"
                 else c for c in contract.all_contracts()]
    findings = kp.check_reachability(PassContext(), contracts)
    assert _codes(findings) == ["dead-no-reason"]
    assert _codes(findings, "allowlisted") == ["dead-kernel"]


def test_reachability_keeps_randomwalk_dispatched(tmp_path):
    """The reference's ruling: ``core/randomwalk`` must stay dispatched;
    a tree where nothing imports it is an error."""
    root = _copy_tree(tmp_path)
    for p in (root / "src/repro_torch").rglob("*.py"):
        if p.name != "randomwalk.py":
            p.write_text(p.read_text().replace("repro_torch.core.randomwalk",
                                               "repro_torch.core.elsewhere"))
    assert "dead-module" in _codes(kp.check_reachability(PassContext(root)))
