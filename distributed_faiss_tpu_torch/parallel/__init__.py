"""Cluster runtime: frame RPC over TCP, the index server and the client."""
