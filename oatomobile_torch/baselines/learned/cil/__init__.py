"""The CIL in-loop policy."""
