"""Layers and kernels of the port (counterparts in ``bpx/ops``)."""
