"""Tensor and expert parallelism (parallel/mesh.py) and pipeline parallelism
(parallel/pipeline.py) over one node's devices."""
