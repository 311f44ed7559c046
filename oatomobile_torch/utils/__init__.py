"""Utilities: spaces, unique tokens, loggers, checkpointing."""
