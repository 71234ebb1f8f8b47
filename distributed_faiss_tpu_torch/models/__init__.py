"""Index models: exact flat scan and IVF-Flat, plus the builder registry."""
