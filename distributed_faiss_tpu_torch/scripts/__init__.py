"""The port's command-line entry points, each run with ``python -m``:
``server_launcher`` (start a cluster) and ``load_data`` (bulk-ingest a
memmap into it)."""
