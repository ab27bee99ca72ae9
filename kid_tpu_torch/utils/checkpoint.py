"""Checkpoint / resume for driver runs (the port's counterpart of
``kid_tpu/utils/checkpoint.py``, with torch-native state files).

The reference's only persistent state is the lookup-table file cache
(run_data/*.data, module_mp_thompson09n.f90:3710,3857); model-state
checkpointing lived in the absent KiD shell.  Here a run saves its
``KidState`` as ``step_<n>.pt`` (``torch.save`` of the 12 channels as CPU
tensors, keyed by field), keeps the three newest, and writes the constants
fingerprint to ``meta.json`` so that a resumed run never mixes tables
built from different constants (the warning at f90:3874-3881 made
mechanical).
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional, Tuple

import torch

from ..device import resolve_device
from ..driver.loop import KidState
from ..tables.cache import constants_fingerprint

MAX_TO_KEEP = 3
_STEP_FILE = re.compile(r"step_(\d+)\.pt$")


class RunCheckpointer:
    """Save/restore (step, KidState) for a named case run."""

    def __init__(self, directory: str, case_name: str):
        self.dir = os.path.abspath(os.path.join(directory, case_name))
        os.makedirs(self.dir, exist_ok=True)
        self._meta_path = os.path.join(self.dir, "meta.json")

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}.pt")

    def steps(self) -> list:
        """The saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                   os.listdir(self.dir)) if m)

    def save(self, step: int, state: KidState):
        meta = {"fingerprint": constants_fingerprint(), "step": int(step)}
        with open(self._meta_path, "w") as f:
            json.dump(meta, f)
        tmp = self._path(step) + f".tmp.{os.getpid()}"
        torch.save({k: v.detach().cpu() for k, v in state._asdict().items()},
                   tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-MAX_TO_KEEP]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device="cuda"
                ) -> Optional[Tuple[int, KidState]]:
        """Returns (step, state on ``device``) or None.  Refuses a
        checkpoint written under different microphysical constants."""
        dev = resolve_device(device)
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                meta = json.load(f)
            if meta.get("fingerprint") != constants_fingerprint():
                raise ValueError(
                    "checkpoint was written with different microphysical "
                    "constants — tables and trajectories are incompatible "
                    "(reference warning at module_mp_thompson09n.f90:"
                    "3874-3881)")
        saved = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        return step, KidState(**{k: saved[k].to(dev)
                                 for k in KidState._fields})
