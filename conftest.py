"""How pytest runs the suite on the CPU: threads, a JAX compile cache, and
the order xdist hands out the test files. Nothing here changes what a test
checks. pytest loads this file before ``tests/conftest.py``.

- torch runs one intra-op thread per test process. The suite runs its files
  in parallel workers (``-n 6`` on 8 cores), and a full-width pool in each
  would oversubscribe the cores. Child processes that the tests start get
  the same variables. XLA's pool is left whole, for the 8 virtual devices.
- Where the process imported JAX, a compile cache of its own: the JAX
  package's ``shard_map``, called outside ``jit``, compiles every primitive
  anew on each call, thousands of identical programs a training step, and
  the cache, keyed by the program, compiles each once
  (``test_gauss_sharded_trains_through_route_overflow`` alone on an idle
  8-core host: 805 s without it, 303 s with). Each process has its own
  directory, as the cache's writes are not atomic.
- Under ``--dist loadfile``, LONG_FILES go to the head of xdist's queue.
"""

import atexit
import os
import shutil
import sys
import tempfile

import pytest

os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")

# The files that take longest, longest first: each runs 8-device sharded
# JAX programs for minutes in one worker. Seconds under the suite's command
# (-n 6 --dist loadfile, 8 cores, with the compile cache): the nine
# gaussian-sharded cases about 764, test_sharding.py's 13 cases about 698.
# xdist's own order sorts files by test count, largest first, which would
# start these two late.
LONG_FILES = (
    "tests/test_gauss_sharded.py",
    "tests/test_sharding.py",
)


def pytest_configure(config):
    jax = sys.modules.get("jax")
    if jax is None:
        return
    cache = tempfile.mkdtemp(prefix="jax-compile-cache-")
    atexit.register(shutil.rmtree, cache, ignore_errors=True)
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)


@pytest.hookimpl(tryfirst=True, optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """xdist's ``loadfile`` (one file per worker) with LONG_FILES at the head
    of its queue before each file is handed out. Written against
    pytest-xdist 3.8: it overrides the private ``_assign_work_unit`` and
    reorders ``workqueue``, whose keys are rootdir-relative file paths. A
    LONG_FILES entry missing from the queue is reported once, so a changed
    xdist or file name does not drop the order silently."""
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class LongFilesFirst(LoadFileScheduling):
        checked = False

        def _assign_work_unit(self, node):
            if not self.checked:
                self.checked = True
                missing = [f for f in LONG_FILES if f not in self.workqueue]
                if missing:
                    config.get_terminal_writer().line(
                        f"conftest.py: not in xdist's queue, left in its order: {missing}")
            for scope in reversed(LONG_FILES):
                if scope in self.workqueue:
                    self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

    return LongFilesFirst(config, log)
