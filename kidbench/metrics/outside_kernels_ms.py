"""Device time a step or a call (the segment's units) of every activity
that is not one of the port's own kernels (torch ops, copies and fills,
NCCL), in ms, over the traced segment (``kidbench.classes``).  It reads
``outside_kernels_ms.loop`` and ``outside_kernels_ms.calls``."""
from kidbench.classes import OWN


def read(trace, cell):
    other = sum(s for k, s in trace.by_class.items() if k != OWN)
    return other / trace.units * 1e3
