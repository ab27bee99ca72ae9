"""The reference's columns on a few worker processes: each worker loads
the host tables once (``tables.get_tables``) and runs the oracle on the
columns it is sent.  The workers are spawned, import only this package,
and are stopped and waited for when the ``Solver`` closes."""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

from .kid import solve_column
from .tables import get_tables

_TABLES = None


def _init(iiwarm: bool):
    global _TABLES
    _TABLES = get_tables(iiwarm)


def _solve(args):
    return solve_column(args, _TABLES)


class Solver:
    """``solve(list of column args) -> list of oracle outputs`` over
    ``workers`` processes; a context manager."""

    def __init__(self, iiwarm: bool, workers: int):
        get_tables(iiwarm)              # built once, here, before the workers
        self.pool = ProcessPoolExecutor(
            max_workers=workers, initializer=_init, initargs=(iiwarm,),
            mp_context=multiprocessing.get_context("spawn"))

    def __call__(self, batch: list) -> list:
        return list(self.pool.map(_solve, batch, chunksize=4))

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
