"""Index models: exact flat scan, IVF-Flat and IVF-PQ, plus the builder
registry."""
