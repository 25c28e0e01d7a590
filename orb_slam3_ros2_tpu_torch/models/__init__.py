"""Camera models (torch)."""
