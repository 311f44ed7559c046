"""The DIM in-loop policy."""
