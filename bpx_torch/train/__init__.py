"""Training of the port (counterparts in ``bpx/train``): losses, the
optimizer and its schedulers, the train / eval steps, the task metrics and
the epoch loop."""
