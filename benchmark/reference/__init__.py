"""The plain reference: a NumPy path tracer of the same semantics as the
renderer, independent of its code (tracer.py)."""
