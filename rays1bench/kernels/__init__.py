"""Pallas kernels for the hot path on the GPU (Triton route): the fused
respawn path tracer (kernels/respawn.py) and the closest-hit index sweep of
the gradient path (kernels/intersect_pallas.py). The pure-XLA pipeline in
render/ is the semantic reference these kernels are validated against.
"""
