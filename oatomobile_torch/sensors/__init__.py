"""On-device observation synthesis."""
