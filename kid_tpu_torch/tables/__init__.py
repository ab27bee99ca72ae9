from .builders import Tables, build_all_tables
from .cache import get_tables

__all__ = ["Tables", "build_all_tables", "get_tables"]
