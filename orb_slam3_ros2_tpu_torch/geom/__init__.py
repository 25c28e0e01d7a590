"""Lie-group operations (torch)."""
