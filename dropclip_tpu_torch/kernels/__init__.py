"""Hand-written Hopper kernels (CUDA C++ sources in ``csrc/``)."""

import threading

_COUNT_LOCK = threading.Lock()


def count_launch(counter) -> None:
    """Add one to ``counter.launches``, under a lock: multi-card ingest
    launches from one worker thread per card, and ``+= 1`` on an
    attribute is a read-modify-write that a thread switch can split."""
    with _COUNT_LOCK:
        counter.launches += 1
