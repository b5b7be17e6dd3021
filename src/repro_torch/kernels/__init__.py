"""Hand-written Hopper kernels (``csrc/``), their builder and wrappers."""
import threading

_launch_lock = threading.Lock()


def count_launch(launches: dict, name: str) -> None:
    """Add one to a wrapper's launch count under a lock: the serving lanes
    launch the graph kernels from several threads."""
    with _launch_lock:
        launches[name] += 1
