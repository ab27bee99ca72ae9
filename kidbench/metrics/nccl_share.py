"""The collective's share of a step, in %: the NCCL kernels' device time,
averaged over the ranks, over the slowest rank's device time
(``TraceSummary.per_rank``).  None where no NCCL kernel ran."""
from kidbench.classes import NCCL


def read(trace, cell):
    nccl = sum(r[NCCL] for r in trace.per_rank) / len(trace.per_rank)
    slowest = max(sum(r.values()) for r in trace.per_rank)
    if nccl <= 0.0 or slowest <= 0.0:
        return None
    return 100.0 * nccl / slowest
