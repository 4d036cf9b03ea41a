"""Pose-graph optimization: the LM and its kernel (K3)."""
