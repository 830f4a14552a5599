"""TPC-H data generation and the numpy/python answer oracle, copied from the
JAX package's `tpch/` (host-only code)."""
