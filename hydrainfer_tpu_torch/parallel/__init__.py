"""Tensor and expert parallelism over one node's devices (parallel/mesh.py)."""
