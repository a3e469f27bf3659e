"""Split the host's cores between pytest-xdist workers for torch's intra-op
thread pool.  Each worker process otherwise starts one OpenMP thread per
core, and six workers on eight cores ran six of the port's test files in
182 s against 105 s with one thread each (the threads of different workers
spinning against each other).  The port's test modules import this module;
it acts once per process, and not at all outside xdist."""

import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


share_cores()
