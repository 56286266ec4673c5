"""The port's task farm (``bpx_torch/cluster/scheduler.py``): the
counterparts of ``tests/test_cluster.py``, a slot's device environment, and
the command line's exit code."""

import os
import subprocess
import sys
from pathlib import Path

from bpx_torch.cluster.scheduler import TaskFarm, main, run_jobs_file

ROOT = Path(__file__).resolve().parent.parent


def test_taskfarm_runs_jobs(tmp_path):
    marker = tmp_path / "out"
    farm = TaskFarm(n_workers=2, log_dir=str(tmp_path / "logs"))
    cmds = [f"{sys.executable} -c \"open('{marker}{i}','w').write('done')\""
            for i in range(4)]
    results = farm.run(cmds)
    assert len(results) == 4
    assert all(r.returncode == 0 for r in results)
    for i in range(4):
        assert os.path.exists(f"{marker}{i}")
    assert all(r.log_path and os.path.exists(r.log_path) for r in results)
    assert [r.command for r in results] == sorted(cmds)


def test_taskfarm_retries_and_reports_failure(tmp_path):
    farm = TaskFarm(n_workers=1, max_retries=2, log_dir=str(tmp_path))
    results = farm.run([f"{sys.executable} -c \"import sys; sys.exit(3)\""])
    assert results[0].returncode == 3
    assert results[0].attempts == 3      # initial + 2 retries


def test_jobs_file_skips_comments(tmp_path):
    jobs = tmp_path / "jobs.txt"
    jobs.write_text(f"# comment line\n{sys.executable} -c \"print('hi')\"\n\n")
    results = run_jobs_file(str(jobs), n_workers=1)
    assert len(results) == 1 and results[0].returncode == 0


def test_each_slot_gets_its_device_env(tmp_path):
    """A job prints its CUDA_VISIBLE_DEVICES into its log: the slot's."""
    farm = TaskFarm(n_workers=2, log_dir=str(tmp_path),
                    device_env=[{"CUDA_VISIBLE_DEVICES": "0"},
                                {"CUDA_VISIBLE_DEVICES": "0"}])
    cmd = (f"{sys.executable} -c \"import os; "
           f"print('cards', os.environ['CUDA_VISIBLE_DEVICES'])\"")
    results = farm.run([cmd, cmd + " ", cmd + "  "])
    assert all(r.returncode == 0 for r in results)
    for r in results:
        assert Path(r.log_path).read_text().strip() == "cards 0"
    assert len({r.log_path for r in results}) == 3


def test_cli_exit_code_and_logs(tmp_path, capsys):
    jobs = tmp_path / "jobs.txt"
    jobs.write_text(f"{sys.executable} -c \"print('ok')\"\n"
                    f"{sys.executable} -c \"import sys; sys.exit(3)\"\n")
    logs = tmp_path / "logs"
    assert main([str(jobs), "--workers", "2", "--log_dir", str(logs),
                 "--max_retries", "1"]) == 1
    out = capsys.readouterr().out
    assert "FAIL(3)" in out and "x2]" in out and "OK" in out
    assert sorted(p.name for p in logs.iterdir()) == ["job0000.log",
                                                      "job0001.log"]
    jobs.write_text(f"{sys.executable} -c \"print('ok')\"\n")
    proc = subprocess.run([sys.executable, "-m", "bpx_torch.cluster.scheduler",
                           str(jobs), "--log_dir", str(logs)], cwd=ROOT,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
