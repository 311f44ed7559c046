"""Baseline agents of the port: the learned in-loop policies."""
