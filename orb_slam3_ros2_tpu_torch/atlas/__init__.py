"""Fixed-capacity map state (torch)."""
