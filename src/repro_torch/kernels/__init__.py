"""Hand-written Hopper kernels (``csrc/``), their builder and wrappers."""
import functools
import threading

_launch_lock = threading.Lock()

#: the active op census (``analysis/census.Census``), or None
_census = None


def count_launch(launches: dict, name: str) -> None:
    """Add one to a wrapper's launch count under a lock: the serving lanes
    launch the graph kernels from several threads."""
    with _launch_lock:
        launches[name] += 1


def set_census(census) -> None:
    """Make ``census`` the one that :func:`launch_site` wrappers report to
    (None: no census)."""
    global _census
    _census = census


def launch_site(name: str):
    """Mark a wrapper as one launch of kernel ``name``.

    With no census active the wrapper runs as it is, behind one global
    read.  Under a census (``analysis/census.py``) the whole call is one
    launch on either device: the census counts it and does not count the
    operations and host reads inside it (the checks, and on the CPU the
    plain version that stands in for the kernel)."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _census is None:
                return fn(*args, **kwargs)
            return _census.opaque(name, fn, args, kwargs)
        return wrapper
    return wrap
