"""Serving-side request scheduling (deadline-aware micro-batching)."""
