"""Command-line entry points of the port (counterparts in ``bpx/cli``)."""
