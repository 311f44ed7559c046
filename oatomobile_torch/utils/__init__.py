"""Framework-free utilities: spaces and unique tokens."""
