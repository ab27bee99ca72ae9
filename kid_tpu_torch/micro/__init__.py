from .state import ColumnState, Precip
from .solver import batched_microphysics, column_microphysics, device_tables

__all__ = ["ColumnState", "Precip", "batched_microphysics",
           "column_microphysics", "device_tables"]
