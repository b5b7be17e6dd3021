"""Static kernel contracts: what each Hopper kernel promises about its
launch and its shared memory.

The port of the JAX package's ``repro.kernels.contract``.  Every kernel
package's ``ops.py`` declares ``CONTRACTS``: :class:`KernelContract` s,
each one *canonical instantiation* of one CUDA kernel (the shapes the
port's paths launch it at), as plain data: the grid, the threads of a
thread block, the cluster, the dynamic shared memory it asks for and the
tiles of its outputs.  ``analysis/kernel_passes.py`` checks them without
building or launching anything:

  * tile divisibility: every output's full dims divide into whole tiles;
  * grid coverage: the grid writes each ``"once"`` output element exactly
    once;
  * limits: dynamic shared memory within one thread block's 232,448 B
    (``fpp/planner.MemoryModel.smem_bytes``), at most 1,024 threads, a
    cluster of at most 8 (the portable size);
  * the planner's model, for *wired* graph kernels: the direct kernels'
    shared memory within ``MemoryModel.working_set``, the fused visit's
    equal to ``MemoryModel.fused_working_set``.

The shared memory of a contract is computed by the same Python function
that the launch path uses where one exists (``fused_visit/ops.smem_bytes``),
else by a Python mirror of the C++ count with the source line beside it;
each library that sizes dynamic shared memory also exports its own count
(``fg_*_smem``), and ``chip_smoke.py`` holds every contract's number
against the built library's.

``wired=False`` declares a kernel that no path outside ``kernels/``
dispatches; the reachability pass checks that claim against the import
graph and demands a ``note`` naming the ruling, so dead code is always an
explicit decision.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional, Tuple

#: kernel packages that must publish CONTRACTS in their ops module
KERNEL_PACKAGES = ("minplus", "frontier", "ppr_push", "fused_visit",
                   "flash_attention", "threefry")
#: the graph kernels' canonical instantiation: 64 query rows over blocks
#: of 128 vertices, the planner's choice on the road graphs
GRAPH_Q, GRAPH_B = 64, 128
#: streaming multiprocessors of an H100 SXM: the CTAs of a persistent
#: launch (the kernels read the count from the card)
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """One output's tiling: the full array and the block one thread block
    (one grid cell) writes.

    ``update`` is the output's write discipline, which decides the
    coverage rule:

      ``"once"``  every element written by exactly one grid cell: the grid
                  tiles the full array (``num_blocks == grid_size``);
      ``"rmw"``   cells read-modify-write rows chosen at run time (the
                  fused visit's partition planes): coverage is the
                  schedule's, not the tiling's;
      ``"accum"`` every cell accumulates into one block (``num_blocks ==
                  1``: the fused visit's stats).
    """
    name: str
    full: Tuple[int, ...]
    block: Tuple[int, ...]
    update: str = "once"

    def num_blocks(self) -> int:
        return math.prod(f // b for f, b in zip(self.full, self.block))

    def divisible(self) -> bool:
        return (len(self.full) == len(self.block)
                and all(f % b == 0 for f, b in zip(self.full, self.block)))


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """The canonical instantiation of one CUDA kernel, as static data."""
    name: str                         # kernel package, e.g. "minplus"
    module: str                       # the ops module that launches it
    kernel: str                       # the __global__ function
    grid: Tuple[int, ...]             # grid cells (tiles) of the launch
    threads: int                      # threads of one thread block
    out_tiles: Tuple[TileSpec, ...]
    wired: bool                       # dispatched outside kernels/?
    note: str = ""                    # for unwired kernels: the ruling
    cluster: int = 1                  # thread blocks of one cluster
    smem_bytes: int = 0               # dynamic shared memory of a block
    #: thread blocks launched where fewer than the grid's cells: a
    #: persistent or grid-stride kernel walks the cells in steps of it
    ctas: Optional[int] = None
    block_size: Optional[int] = None  # B of a graph kernel's instantiation
    num_queries: Optional[int] = None  # Q of same; None for other kernels
    #: the fused visit: shared memory checked against
    #: ``MemoryModel.fused_working_set`` of ``num_planes`` value planes
    fused_model: bool = False
    num_planes: Optional[int] = None
    #: the instantiation's (name, value) pairs that the package's
    #: ``library_smem_bytes`` passes to the library's own count
    args: Tuple[Tuple[str, object], ...] = ()

    def grid_size(self) -> int:
        return math.prod(self.grid)

    def arg(self, name: str):
        return dict(self.args)[name]


def all_contracts() -> Tuple[KernelContract, ...]:
    """Every kernel package's declared contracts."""
    out = []
    for pkg in KERNEL_PACKAGES:
        ops = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
        contracts = getattr(ops, "CONTRACTS", None)
        if contracts is None:
            raise RuntimeError(f"repro_torch.kernels.{pkg}.ops declares no "
                               f"CONTRACTS: every kernel package publishes "
                               f"its static contract")
        out.extend(contracts)
    return tuple(out)
