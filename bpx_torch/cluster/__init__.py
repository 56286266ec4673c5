"""Experiment orchestration (counterpart: ``bpx/cluster``)."""

from bpx_torch.cluster.scheduler import JobResult, TaskFarm, run_jobs_file
