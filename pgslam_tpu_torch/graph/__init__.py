"""Pose-graph store and shortest paths."""
