"""Index models: exact flat scan, IVF-Flat, IVF-PQ (flat PQ is IVF-PQ with
one list), the OPQ/PCA pre-transform wrapper, plus the builder registry."""
