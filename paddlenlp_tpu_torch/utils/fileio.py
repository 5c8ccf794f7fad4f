"""Crash-safe file helpers: tmp+rename atomic writes and fsync plumbing.

A process can die at any byte of a ``write()`` — after a preemption, the only
states a reader may observe for a file are "old content" or "new content in
full". ``atomic_write`` gives that contract to every small metadata file the
stack persists (``trainer_state.json``, the checkpoint ``commit.json``): the
payload is written to a same-directory temp file, flushed, fsync'd, and
``os.replace``'d over the target (atomic on POSIX within one filesystem).

A copy of ``paddlenlp_tpu/utils/fileio.py``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import IO, Iterator

__all__ = ["atomic_write", "fsync_file", "fsync_dir"]


def fsync_file(path: str):
    """fsync an already-written file's contents to stable storage."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str):
    """fsync a directory entry (makes a rename/creation durable). Best-effort:
    some filesystems refuse O_RDONLY on dirs — crash-consistency degrades to
    the filesystem's journal guarantee there, which is still rename-atomic."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "w", encoding: str = None,
                 fsync: bool = True) -> Iterator[IO]:
    """``with atomic_write(p) as f: f.write(...)`` — all-or-nothing replace.

    The temp file lives in the target's directory (rename must not cross
    filesystems). On any exception the temp file is removed and the target is
    untouched; on success the replace is atomic and (with ``fsync=True``) the
    rename itself is made durable by fsyncing the parent directory."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        if "b" in mode:
            f = os.fdopen(fd, mode)
        else:
            f = os.fdopen(fd, mode, encoding=encoding)
        with f:
            yield f
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
