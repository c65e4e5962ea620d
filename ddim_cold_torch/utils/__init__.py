"""Host-side helpers: device resolution, the weight bridge, latency stats."""
