"""Static checks of the port's kernels (``kernel_passes``): the part of the
JAX package's ``repro.analysis`` that its kernel-contract passes need, a
:class:`Finding` and a :class:`PassContext`.  The reference's other pass
families read jaxprs and compiled HLO, which the port does not have."""
from __future__ import annotations

import dataclasses
import pathlib

#: severity ladder: only "error" fails.  "allowlisted" is a warning with an
#: explicit standing excuse (a dead kernel's ruling).
SEVERITIES = ("error", "warning", "allowlisted", "info")


def repo_root() -> pathlib.Path:
    """The checkout this package sits in (``.../src/repro_torch/analysis``)."""
    return pathlib.Path(__file__).resolve().parents[3]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One fact a pass established about the code."""
    pass_name: str     # e.g. "kernels.contracts"
    code: str          # a stable tag, e.g. "grid-coverage"
    severity: str      # one of SEVERITIES
    location: str      # a module or a path
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; one of "
                             f"{SEVERITIES}")

    def render(self) -> str:
        return (f"[{self.severity:>11}] {self.pass_name} {self.code} @ "
                f"{self.location}: {self.message}")


@dataclasses.dataclass
class PassContext:
    """What a pass may need: the checkout whose ``src/repro_torch`` it
    reads."""
    root: pathlib.Path = dataclasses.field(default_factory=repo_root)

    def __post_init__(self):
        self.root = pathlib.Path(self.root)
