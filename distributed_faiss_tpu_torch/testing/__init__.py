"""Test tooling for the port: link faults through a proxy, process-level
rank kill and restart, and live query load (testing/chaos.py)."""
