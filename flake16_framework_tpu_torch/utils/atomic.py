"""Crash-consistent file writes (a copy of the JAX package's
``utils/atomic.py``): the payload goes to a temporary sibling in the same
directory, is flushed and fsync'd, renamed onto the target with
``os.replace`` and the directory fsync'd, so a killed writer leaves the
previous complete file, never a torn one."""

import contextlib
import os
import tempfile


def _fsync_dir(dirname):
    """Make a just-completed rename durable. Best-effort: some
    filesystems refuse an fsync of a directory opened read-only."""
    try:
        dfd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


@contextlib.contextmanager
def atomic_write(path, mode="wb", **open_kw):
    """Context manager yielding a file object; on a clean exit the payload
    is fsync'd and renamed onto ``path``. On any exception the temporary
    file is removed and ``path`` is untouched. ``mode`` is "wb" or "w"
    (text; pass ``encoding=`` through ``open_kw``)."""
    path = os.fspath(path)
    dirname = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(
        dir=dirname, prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        # mkstemp creates 0600; the files are shared read like any
        # open()-created file.
        os.chmod(tmp, 0o644)
        with os.fdopen(fd, mode, **open_kw) as out:
            yield out
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(dirname)


def atomic_write_bytes(path, data):
    """Write ``data`` to ``path`` through ``atomic_write``."""
    with atomic_write(path, "wb") as fd:
        fd.write(data)
