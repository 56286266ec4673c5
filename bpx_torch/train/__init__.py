"""Training of the port (counterparts in ``bpx/train``): losses, the
optimizer and its schedulers, and the train / eval steps."""
