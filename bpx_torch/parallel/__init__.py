"""Multi-card training (counterpart: ``bpx/parallel``): the process group
and the ``(data, fsdp, tensor)`` mesh (``mesh.py``), the placement of the
model and the batch on it (``sharding.py``), and the tensor split's
collectives (``collectives.py``).  Import the submodules; the package
itself imports none, so the ops can use ``collectives`` without reaching
the model code ``sharding`` imports."""
