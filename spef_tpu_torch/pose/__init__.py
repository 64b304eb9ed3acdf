"""Pose math (quaternions) in PyTorch."""
