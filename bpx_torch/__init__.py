"""bpx_torch: the PyTorch and CUDA port of the bpx framework.

A second package beside ``bpx`` (the JAX reference, which it never
imports).  Entry points run on the CUDA device unless the caller passes
``device="cpu"``; every TPU kernel on the ported path is a hand-written CUDA
kernel under ``bpx_torch/csrc`` with a plain PyTorch version beside it.
"""
