"""Host-side helpers: device resolution, the weight bridge, checkpoints,
profiler traces and scopes, latency stats, FLOP accounting, bench records."""
