"""One intra-op thread for the port's CPU tests.

Each port test module imports the autouse fixture:

    from torch_threads import torch_one_thread  # noqa: F401

and its tests then run torch at one intra-op thread; the caller's count
is back when the module's last test is done.  The port's tests are
small-shape CPU work: at torch's default count every small op waits at
a barrier for one OpenMP thread a core, and when several test processes
share the host those threads are descheduled, so a test costs many
times its work.  One thread changes no result a test compares: the
bitwise pins hold port runs against each other at one count.

Free-running proc workers take the caller's count from the runconfig
(`runtime.launch.run_proc`), so a test's workers follow the fixture; a
lock-step CPU run fixes its own (`runtime.launch.LOCKSTEP_CPU_THREADS`).
"""
import pytest
import torch

TEST_THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """Run the importing module's tests at `TEST_THREADS` intra-op threads,
    then restore the caller's count."""
    old = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    try:
        yield TEST_THREADS
    finally:
        torch.set_num_threads(old)
