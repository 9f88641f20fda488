"""Share the machine's cores among pytest-xdist workers.

Each worker's torch would otherwise start as many intra-op threads as the
machine has cores, so ``-n 6`` on 8 cores runs 48 threads, and every small
eager op waits at a barrier for threads that are not scheduled. Under xdist
each worker takes ``cores // workers`` threads (at least one), read from the
cores this process may run on and xdist's worker count. ``OMP_NUM_THREADS``
(unless already set) carries the share to numpy's BLAS and to the processes
a test spawns; ``torch.set_num_threads`` to the worker itself. Without xdist
nothing is set.

pytest loads this file before ``tests/conftest.py``, so the share is in place
before any test module imports torch or numpy.
"""

import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    _share = max(1, len(os.sched_getaffinity(0)) // int(_workers))
    os.environ.setdefault("OMP_NUM_THREADS", str(_share))

    import torch  # noqa: E402

    torch.set_num_threads(_share)
