"""Carry tables and state across from numpy (and so from the reference
package, whose ``Tables`` fields and state channels are numpy-convertible
arrays of the same names)."""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .driver.loop import KidState
from .micro.solver import DeviceTables, device_tables
from .micro.state import ColumnState
from .tables.builders import Tables


def tables_from_numpy(tables_like, dtype=torch.float32,
                      device="cuda") -> DeviceTables:
    """The port's ``DeviceTables`` from any object whose attributes are
    the ``Tables`` fields as arrays (e.g. ``kid_tpu.tables.get_tables()``)."""
    tables = Tables(*[np.asarray(getattr(tables_like, f), np.float64)
                      for f in Tables._fields])
    return device_tables(tables, dtype, device)


def state_from_numpy(state_like, device="cuda", dtype=torch.float64):
    """The 12 channels of a ``KidState`` (has ``theta``) or a
    ``ColumnState`` (has ``t``) as the port's tuple of the same kind, with
    tensors of ``dtype`` on ``device``."""
    kind = KidState if hasattr(state_like, "theta") else ColumnState
    dev = resolve_device(device)
    return kind(*[torch.as_tensor(np.array(getattr(state_like, f),
                                           np.float64), dtype=dtype).to(dev)
                  for f in kind._fields])
