"""Feature extraction and per-frame tracking (torch)."""
