"""The processes a run starts, stopped and waited for before it prints.

A run starts processes of its own (the ranks of a sharded cell, the
reference's workers, ``nvcc``) and, through ``multiprocessing``'s spawn,
a resource tracker that lives until its parent closes a pipe to it: at
the parent's exit, unless it is stopped first.  ``adopt_orphans`` makes
the command's process the reaper of what its descendants leave behind;
``Children`` takes note of the children there are when it opens and, at
``stop``, stops the tracker if the run started it, waits for every other
new child and ends those that outstay ``grace``."""
from __future__ import annotations

import ctypes
import os
import signal
import time
from pathlib import Path

PR_SET_CHILD_SUBREAPER = 36


def adopt_orphans() -> None:
    """Make this process the parent of every descendant orphaned below
    it (Linux), so that ``Children.stop`` waits for it too."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1,
                                                0, 0, 0)
    except (OSError, AttributeError):
        pass


def children() -> set:
    """Pids whose parent is this process, zombies included."""
    me, found = os.getpid(), set()
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            text = stat.read_text()
        except OSError:
            continue
        if int(text.rsplit(")", 1)[1].split()[1]) == me:
            found.add(int(stat.parent.name))
    return found


def _tracker():
    from multiprocessing import resource_tracker
    return resource_tracker._resource_tracker


def _command(pid: int) -> str:
    try:
        raw = Path(f"/proc/{pid}/cmdline").read_bytes()
    except OSError:
        return str(pid)
    return f"{pid} " + raw.replace(b"\0", b" ").decode(errors="replace")[:160]


def _reap(pids: set) -> set:
    """The pids of ``pids`` that have not ended (the ended ones waited
    for)."""
    alive = set()
    for pid in pids:
        try:
            done, _ = os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            continue
        if not done:
            alive.add(pid)
    return alive


class Children:
    """The children this process starts from now on."""

    def __init__(self):
        self.before = children()
        self.tracker_before = _tracker()._pid

    def stop(self, grace: float = 10.0) -> list:
        """Stop the resource tracker where it started after ``__init__``,
        wait up to ``grace`` seconds for the other new children to end,
        then end the rest (SIGTERM, SIGKILL 5 s later) and wait for them
        (30 s at most).  Returns the commands of those that had to be
        ended."""
        tracker = _tracker()
        if tracker._pid is not None and tracker._pid != self.tracker_before:
            tracker._stop()
        deadline = time.monotonic() + grace
        while True:
            alive = _reap(children() - self.before)
            if not alive or time.monotonic() >= deadline:
                break
            time.sleep(0.05)
        ended = [_command(pid) for pid in sorted(alive)]
        for sig, wait in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 30.0)):
            for pid in alive:
                try:
                    os.kill(pid, sig)
                except ProcessLookupError:
                    pass
            deadline = time.monotonic() + wait
            while alive and time.monotonic() < deadline:
                time.sleep(0.05)
                alive = _reap(alive)
        return ended
