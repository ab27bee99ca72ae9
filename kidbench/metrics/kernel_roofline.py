"""The port's own kernels' share of their roofline, in %: the least time
the card could take for one step's or one call's microphysics work,
frozen in the configuration's ``work`` block (``kidbench.work``), over
the own kernels' device time a step or a call (the segment's units) in
the traced segment.  None where no own kernel ran.  It reads
``kernel_roofline.loop`` and ``kernel_roofline.calls``."""
from kidbench.classes import OWN
from kidbench.peaks import bound_seconds


def read(trace, cell):
    own = trace.by_class[OWN]
    if own <= 0.0:
        return None
    work = cell.cfg["work"]
    bound = bound_seconds(work["bytes"], work["ops"])
    return 100.0 * bound * trace.units / own
