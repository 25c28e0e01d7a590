"""Residuals and the pose-only optimizer (torch)."""
