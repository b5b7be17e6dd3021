"""The front door: ``FPPSession`` (plan → execute), planner, backends."""
from repro_torch.fpp.session import FPPSession, SessionResult

__all__ = ["FPPSession", "SessionResult"]
