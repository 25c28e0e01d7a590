"""Host utilities: the stage tracer."""
