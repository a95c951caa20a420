"""The work pool and its progress line (a copy of the JAX package's
``runner/pool.py``): the work in a seeded shuffled order, results as
they complete, and a ``done/remaining elapsed/ETA-minutes`` line
rewritten in place. The pool is injectable, so orchestration is tested
without forking."""

import random
import sys
import time
from multiprocessing import Pool


def run_pool(fn, args, *, n_proc=None, out=sys.stdout, shuffle=True,
             pool_factory=Pool, seed=None):
    """Yield fn(arg) results as they complete, printing progress.

    ``fn`` returns (message, result) and must be picklable (a
    module-level function or a ``functools.partial`` of one).
    ``pool_factory(processes=...)`` may be swapped for a serial fake in
    tests.
    """
    args = list(args)
    if shuffle:
        random.Random(seed).shuffle(args)

    n_finish = 0
    t_start = time.time()
    out.write(f"0/{len(args)} 0/?\r")

    with pool_factory(processes=n_proc) as pool:
        for message, result in pool.imap_unordered(fn, args):
            n_finish += 1
            n_remain = len(args) - n_finish

            t_elapse = time.time() - t_start
            t_remain = t_elapse / n_finish * n_remain

            out.write(f"{message}\n\r")
            out.write(
                f"{n_finish}/{n_remain} "
                f"{round(t_elapse / 60)}/{round(t_remain / 60)}\r"
            )
            yield result


class SerialPool:
    """In-process pool for tests and single-core debugging."""

    def __init__(self, processes=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def imap_unordered(self, fn, args):
        return map(fn, args)

    def map(self, fn, args):
        return list(map(fn, args))

    def starmap(self, fn, args):
        return [fn(*a) for a in args]
