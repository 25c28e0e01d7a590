"""The per-frame tracking program (torch)."""
