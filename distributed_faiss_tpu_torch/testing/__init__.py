"""Test tooling for the port: process-level rank kill and restart, and
live query load (testing/chaos.py)."""
