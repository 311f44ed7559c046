"""Observation ops: the BEV LIDAR splat (plain and CUDA)."""
