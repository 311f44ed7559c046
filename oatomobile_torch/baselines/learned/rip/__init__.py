"""The RIP planner and in-loop policy."""
