"""Tuning entry points of the port (counterparts of ``benchmarks/``)."""
