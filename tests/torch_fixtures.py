"""What the ``test_torch_*`` modules share: their module fixture, and a
way to build a module's JAX reference once a test session.

A module takes the fixture by importing it:

    from torch_fixtures import one_thread_then_free_programs  # noqa: F401

``one_thread_then_free_programs`` wraps the module:

* torch's intra-op thread count is 1 for the module. The port's CPU bits
  depend on how a reduction is split over threads, and many tests compare
  two port runs bit for bit (bulk against streaming, the online worker
  against the offline loop, a shared step cache against separate ones).
  An explicit count is also what a thread the test starts (the online
  estimator's worker) takes, where a thread that never set it takes the
  math libraries' defaults. One thread a process also keeps the xdist
  workers from oversubscribing the host.
* After the module, the XLA:CPU programs it compiled are freed. A process
  keeps the code of every compiled program mapped until the caches are
  cleared, and a long-lived test process that has compiled many reaches
  the kernel's limit on memory maps (vm.max_map_count) and aborts in its
  next compile.

``build_once`` is for a module-scoped reference that several cases read.
Under ``pytest-xdist --dist load`` a module's cases are dealt out to
several workers, and each worker would build the reference again; almost
all of its time is XLA's compile of the JAX package's step programs.
"""

import fcntl
import gc
import os
import pickle

import jax
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread_then_free_programs():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    gc.collect()


def build_once(tmp_path_factory, key, build):
    """``build()``'s result, built once a test session. Under xdist the
    first worker to ask builds it and leaves it pickled in the session's
    temporary directory, which the workers share; the others wait for it
    and load it. ``key`` names the result within the session."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return build()
    path = tmp_path_factory.getbasetemp().parent / f"{key}.pkl"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return pickle.loads(path.read_bytes())
        value = build()
        part = path.with_suffix(".part")
        part.write_bytes(pickle.dumps(value))
        part.replace(path)
        return value
