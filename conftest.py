"""Share the host's CPUs among pytest-xdist workers.

torch's intra-op pool defaults to one thread per core, so each of N
workers running its own pool puts N times as many threads as there are
cores on the host, and the heavy port tests spend most of their time
waiting for a core.  In an xdist worker, and only there, torch gets
cpus // workers threads, and every subprocess a test starts inherits the
same share through OMP_NUM_THREADS.  A single-process run keeps torch's
defaults.
"""

import os

_workers = os.environ.get('PYTEST_XDIST_WORKER_COUNT')
if _workers:
    _threads = max(1, len(os.sched_getaffinity(0)) // int(_workers))
    os.environ.setdefault('OMP_NUM_THREADS', str(_threads))

    import torch
    torch.set_num_threads(_threads)
