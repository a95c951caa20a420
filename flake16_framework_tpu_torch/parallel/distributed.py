"""The process group of a config batch that spans processes: the
cross-process part of the JAX package's mesh path (``make_sharded_cv_fns``
on a mesh over ``jax.distributed`` processes, and its multi-host tool's
``put`` and resharding), over ``torch.distributed`` with ``gloo``.

What crosses processes is each rank's host counts, int32 [b, P, 3] (or
[b, folds, P, 3]), a few kB that ``run_config_batch`` copies to the host
anyway, so the gather runs on the CPU. NCCL is not needed, and it refuses
two ranks on one card, the only layout a one-card machine gives.

No cluster is discovered: ``join`` takes the rendezvous address
(``tcp://host:port`` or ``file://path``), the world size and the rank by
hand, with a bounded timeout. ``ProcessGroup.gather`` does not hang on a
failure: a rank whose work raised joins the gather with its error, then
every rank raises ``RankFailed`` naming each failed rank and its error;
a rank that dies outright ends the others' gather with ``GatherFailed``
(at once when its sockets close, else at the group's timeout).
"""

import datetime
import time

import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


class RankFailed(RuntimeError):
    """A rank's share of the work raised; ``failed`` is {rank: error}."""

    def __init__(self, rank, failed):
        self.failed = failed
        super().__init__("; ".join(
            f"rank {r} failed: {text}" for r, text in sorted(failed.items()))
            + f" (raised on rank {rank})")


class GatherFailed(RuntimeError):
    """The gather itself failed: a rank died, or the timeout passed."""


class ProcessGroup:
    """A joined group (``join``): ``rank``, ``world_size``, ``timeout_s``,
    and ``gather_s``, the wall of this rank's last gather."""

    def __init__(self, rank, world_size, timeout_s):
        self.rank = rank
        self.world_size = world_size
        self.timeout_s = timeout_s
        self.gather_s = None

    def gather(self, thunk):
        """Run ``thunk`` (this rank's work) and all-gather its result: the
        list of every rank's results in rank order. Raises ``RankFailed``
        on every rank when any rank's ``thunk`` raised, and
        ``GatherFailed`` when the gather cannot complete."""
        own = None
        try:
            payload = (True, thunk())
        # Every rank must reach the gather, a failed one with its error.
        except Exception as e:
            own = e
            payload = (False, f"{type(e).__name__}: {e}")
        got = [None] * self.world_size
        t0 = time.time()
        try:
            dist.all_gather_object(got, payload)
        except RuntimeError as e:
            raise GatherFailed(
                f"rank {self.rank}: the gather over {self.world_size} ranks "
                f"failed (a rank died, or the {self.timeout_s:g} s timeout "
                f"passed)" + (f"; this rank's work had failed: {payload[1]}"
                              if own is not None else "") + f": {e}") from e
        self.gather_s = time.time() - t0
        failed = {r: res for r, (ok, res) in enumerate(got) if not ok}
        if failed:
            raise RankFailed(self.rank, failed) from own
        return [res for _, res in got]

    def close(self):
        """Leave the group (a no-op once left)."""
        if dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def join(init_method, world_size, rank, timeout_s=DEFAULT_TIMEOUT_S):
    """Join the ``gloo`` group at ``init_method`` as ``rank`` of
    ``world_size``; rendezvous and every collective give up after
    ``timeout_s`` seconds. One group a process."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not in a world of {world_size}")
    if dist.is_initialized():
        raise RuntimeError("this process has joined a group already")
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return ProcessGroup(rank, world_size, timeout_s)
