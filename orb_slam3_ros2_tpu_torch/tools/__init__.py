"""Command-line tools that drive the port."""
