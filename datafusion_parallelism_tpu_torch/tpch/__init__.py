"""TPC-H data generation, the 22 queries and the numpy/python answer oracle,
copied from the JAX package's `tpch/` (host-only code)."""
from .datagen import TABLE_NAMES, generate_tables
from .queries import QUERIES, query_sql

__all__ = ["generate_tables", "TABLE_NAMES", "QUERIES", "query_sql"]
