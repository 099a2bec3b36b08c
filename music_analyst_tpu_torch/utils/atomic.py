"""Atomic artifact writes: stage to a tmp file, publish with one rename.

The engines' output files (``word_counts.csv``, ``top_artists.csv``,
``performance_metrics.json``, ``sentiment_totals.json``) are contracts —
resume logic and the differential tests trust whatever is on disk.  A
crash mid-``write()`` used to leave a torn file under the final name;
with this helper the final name either holds the previous complete
artifact or the new complete artifact, never a prefix.  Same pattern the
corpus/wq caches already use for directory entries (stage under
``<name>.tmp-<pid>-<uuid>``, publish with one ``os.replace``).

``os.replace`` (not ``rename``) so an existing artifact from a previous
run is overwritten in one step on every platform.

Atomicity alone is only crash-consistent against *process* death: after
a machine crash the rename may be on disk while the data blocks are not,
publishing a complete-looking file full of zeros.  ``durable=True`` adds
the two fsyncs the rename trick needs to be an actual write barrier —
the staged file before the rename (data reaches the platter before the
name does) and the parent directory after it (the rename itself reaches
the platter).  The request journal (``serving/journal.py``) sets it;
bulk artifact writers keep the fast default, and
``$MUSICAAL_ATOMIC_FSYNC=1`` upgrades every atomic write for paranoid
deployments (``=0`` forces it off for tests that hammer tiny files).
"""

from __future__ import annotations

import contextlib
import os
import uuid
from typing import IO, Iterator, Optional


def _fsync_wanted(durable: Optional[bool]) -> bool:
    """Explicit ``durable`` wins; else ``$MUSICAAL_ATOMIC_FSYNC`` (1/0);
    else off — the historical behavior, cheap for bulk artifacts."""
    env = os.environ.get("MUSICAAL_ATOMIC_FSYNC", "").strip()
    if durable is not None:
        return bool(durable)
    return env in ("1", "true", "yes")


def fsync_dir(directory: str) -> None:
    """fsync a directory so a rename/create inside it is on disk.

    Best-effort on platforms whose directories can't be opened for
    fsync; the journal's replay tolerates the resulting (tiny) window.
    """
    try:
        dir_fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dir_fd)
    except OSError:
        pass
    finally:
        os.close(dir_fd)


@contextlib.contextmanager
def atomic_write(
    path: str,
    mode: str = "w",
    encoding: Optional[str] = "utf-8",
    newline: Optional[str] = None,
    durable: Optional[bool] = None,
) -> Iterator[IO]:
    """Open a staging file that replaces ``path`` only on a clean exit.

    On any exception the staging file is removed and ``path`` is left
    untouched.  Binary modes pass ``encoding=None``.  ``durable=True``
    fsyncs the staged file before the rename and the parent directory
    after it (see module docstring); ``None`` defers to
    ``$MUSICAAL_ATOMIC_FSYNC``.
    """
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(
        directory,
        f"{os.path.basename(path)}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}",
    )
    fsync = _fsync_wanted(durable)
    fh = open(tmp, mode, encoding=encoding, newline=newline)
    try:
        yield fh
        fh.flush()
        if fsync:
            os.fsync(fh.fileno())
        fh.close()
        os.replace(tmp, path)
        if fsync:
            fsync_dir(directory)
    except BaseException:
        fh.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
