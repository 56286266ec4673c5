"""Experiment task farm (counterpart: ``bpx/cluster/scheduler.py``).

The reference fans experiments out with SLURM and an MPI task scheduler:
each line of ``jobs_to_run.txt`` is an independent training command, and
MPI only distributes whole experiments, with no communication inside a job.
Here a pool of worker slots pops job lines and runs each as a subprocess;
slot i's environment takes ``device_env[i]``, so a slot names its cards
with ``CUDA_VISIBLE_DEVICES`` (several slots may share one card).  A job
that fails is run again up to ``max_retries`` times; each job's output
goes to its own log in ``log_dir``.  Host-only: no kernel is involved.

    python -m bpx_torch.cluster.scheduler jobs.txt --workers 2 \\
        --log_dir logs --max_retries 1

exits 1 if any job failed after its retries.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from queue import Empty, Queue
from typing import Dict, List, Optional, Sequence


@dataclass
class JobResult:
    command: str
    returncode: int
    attempts: int
    seconds: float
    log_path: Optional[str] = None


class TaskFarm:
    """Run independent job command lines over a pool of worker slots."""

    def __init__(self, n_workers: int = 1, log_dir: Optional[str] = None,
                 max_retries: int = 1,
                 device_env: Optional[Sequence[Dict[str, str]]] = None):
        """``device_env``: per-slot environment overrides, e.g. one card
        per slot with ``{"CUDA_VISIBLE_DEVICES": "0"}``."""
        self.n_workers = n_workers
        self.log_dir = log_dir
        self.max_retries = max_retries
        self.device_env = list(device_env) if device_env else [{}] * n_workers
        if len(self.device_env) != n_workers:
            raise ValueError(f"{len(self.device_env)} device_env entries for "
                             f"{n_workers} workers")

    def _run_one(self, slot: int, idx: int, command: str) -> JobResult:
        env = dict(os.environ)
        env.update(self.device_env[slot])
        log_path = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            log_path = os.path.join(self.log_dir, f"job{idx:04d}.log")
        attempts = 0
        t0 = time.time()
        while True:
            attempts += 1
            with (open(log_path, "ab") if log_path
                  else open(os.devnull, "wb")) as out:
                rc = subprocess.run(shlex.split(command), env=env,
                                    stdout=out,
                                    stderr=subprocess.STDOUT).returncode
            if rc == 0 or attempts > self.max_retries:
                break
        return JobResult(command, rc, attempts, time.time() - t0, log_path)

    def run(self, commands: Sequence[str]) -> List[JobResult]:
        """Run every command line (blank and ``#`` lines skipped); the
        results sorted by command."""
        queue: Queue = Queue()
        for i, cmd in enumerate(commands):
            cmd = cmd.strip()
            if cmd and not cmd.startswith("#"):
                queue.put((i, cmd))
        results: List[JobResult] = []
        lock = threading.Lock()

        def worker(slot: int):
            while True:
                try:
                    idx, cmd = queue.get_nowait()
                except Empty:
                    return
                res = self._run_one(slot, idx, cmd)
                with lock:
                    results.append(res)

        threads = [threading.Thread(target=worker, args=(s,), daemon=True)
                   for s in range(self.n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return sorted(results, key=lambda r: r.command)


def run_jobs_file(path: str, n_workers: int = 1,
                  log_dir: Optional[str] = None,
                  max_retries: int = 1) -> List[JobResult]:
    """Run every line of a jobs file (the reference's ``jobs_to_run.txt``
    format: one command a line)."""
    with open(path) as f:
        commands = f.readlines()
    farm = TaskFarm(n_workers=n_workers, log_dir=log_dir,
                    max_retries=max_retries)
    return farm.run(commands)


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        description="bpx_torch task-farm scheduler (MPI_Scheduler "
                    "equivalent)")
    parser.add_argument("jobs_file")
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--log_dir", type=str, default="outputs")
    parser.add_argument("--max_retries", type=int, default=1)
    args = parser.parse_args(argv)
    results = run_jobs_file(args.jobs_file, args.workers, args.log_dir,
                            args.max_retries)
    for r in results:
        status = "OK" if r.returncode == 0 else f"FAIL({r.returncode})"
        print(f"{status} [{r.seconds:.0f}s x{r.attempts}] {r.command}")
    return 1 if any(r.returncode != 0 for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
