"""Host-side helpers: config, lifecycle state, persistence, latency stats,
device resolution."""
