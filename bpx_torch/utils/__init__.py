"""Logging, seeding, checkpointing, artifacts (counterparts in
``bpx/utils``)."""

from bpx_torch.utils.logging import create_logger
from bpx_torch.utils.seeding import set_seed
