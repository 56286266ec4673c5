"""The port's training CLI against the JAX package's.

``args_to_config`` gives bpx's config over a list of command lines (the
defaults, ``--preset``, the inverted ``store_false`` flags, the BERT
variants, ``--task synthetic``); every bpx flag exists with its default.
``cli_main`` trains and tests a tiny synthetic run on the CPU (the split
seed sweep), with ``--hybrid --optimizer radam --accum_dtype bfloat16``,
and runs the 10-fold cross-validation path; a notebook-era model trains
with ``--hybrid``, which it ignores as the JAX package's does;
``python -m bpx_torch.cli.train --help`` exits 0.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bpx.cli import train as jcli

from bpx_torch.cli import train as cli
from bpx_torch.config import BertConfig
from tests.test_torch_data import _write_task
from tests.test_torch_loop import few_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGVS = [
    [],
    ["--preset", "moviescope"],
    ["--preset", "iemocap", "--model", "mmtrvat", "--fusion", "mag"],
    ["--vonly", "--lonly", "--aonly", "--attn_mask"],
    ["--bert_model", "distilbert-base-uncased", "--bert_gelu", "tanh",
     "--bert_weights", "/w", "--freeze_txt", "1"],
    ["--bert_model", "bert-large-uncased", "--use_audio_encoder", "0"],
    ["--task", "synthetic", "--orig_d_l", "64", "--max_seq_len", "32",
     "--use_audio_encoder", "1", "--compute_dtype", "float32"],
    ["--task", "cmu-mosi", "--task_type", "classification", "--model",
     "mmtrvat", "--weight_classes", "0", "--feature_cache", "0",
     "--inverse_seed", "--just_test", "--output_gates", "--mesh_data", "2",
     "--accum_dtype", "bfloat16", "--scan_layers", "--remat",
     "--attention_impl", "pallas", "--optimizer", "adamw"],
]


def _parse(module, argv):
    parser = argparse.ArgumentParser()
    module.get_args(parser)
    return parser.parse_args(argv)


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_args_to_config_matches_bpx(argv):
    got = cli.args_to_config(_parse(cli, argv))
    want = jcli.args_to_config(_parse(jcli, argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_every_bpx_flag_with_its_default():
    got = vars(_parse(cli, []))
    assert got.pop("device") == "cuda"
    assert got == vars(_parse(jcli, []))


SMALL = ["--task", "synthetic", "--model", "mmtrvapt", "--batch_sz", "8",
         "--gradient_accumulation_steps", "2", "--num_vectors_l", "16",
         "--num_vectors_a", "8", "--num_vectors_v", "8", "--orig_d_l", "32",
         "--orig_d_v", "24", "--orig_d_a", "16", "--orig_d_p", "20",
         "--hidden_sz", "32", "--num_heads", "2", "--layers", "1",
         "--max_seq_len", "16", "--audio_raw_len", "400", "--video_len",
         "8", "--compute_dtype", "float32", "--use_audio_encoder", "1",
         "--device", "cpu"]


def test_cli_trains_and_tests_on_the_cpu(tmp_path):
    results = cli.cli_main(SMALL + [
        "--max_epochs", "1", "--from_seed", "2", "--to_seed", "2",
        "--savedir", str(tmp_path), "--name", "cli", "--output_gates"])
    assert list(results) == [2] and "auc_pr_micro" in results[2]
    run = tmp_path / "cli_Seed2_run"
    for name in ("best", "latest", "host_state.json", "config.json",
                 "logfile.log", "logfileTest.log", "test_labels_pred.txt",
                 "test_labels_gold.txt", "test_labels.txt", "preds_raw.npy",
                 "gates.npy"):
        assert (run / name).exists(), name
    # --just_test restores best and writes the same predictions
    raw = np.load(run / "preds_raw.npy")
    cli.cli_main(SMALL + ["--just_test", "--from_seed", "2", "--to_seed",
                          "2", "--savedir", str(tmp_path), "--name", "cli"])
    np.testing.assert_array_equal(np.load(run / "preds_raw.npy"), raw)


def test_cli_trains_hybrid_radam_bf16_accumulation(tmp_path):
    """``--hybrid --optimizer radam --accum_dtype bfloat16`` reach the
    port: the early-fusion model trains with RAdam and bf16 accumulation
    and tests a run."""
    import torch
    results = cli.cli_main(SMALL + [
        "--hybrid", "--optimizer", "radam", "--accum_dtype", "bfloat16",
        "--max_epochs", "1", "--from_seed", "2", "--to_seed", "2",
        "--savedir", str(tmp_path), "--name", "opts"])
    assert list(results) == [2] and "auc_pr_micro" in results[2]
    run = tmp_path / "opts_Seed2_run"
    with open(run / "config.json") as f:
        saved = json.load(f)
    assert saved["model"]["hybrid"]
    assert saved["train"]["optimizer"] == "radam"
    assert saved["train"]["accum_dtype"] == "bfloat16"
    weights = torch.load(run / "latest" / "model.pt")["model"]
    assert weights["gmu.x_gates.weight"].shape == (5 * 32, 5 * 32)
    assert "trans_l_early.layers.2.fc1.weight" in weights
    saved = torch.load(run / "latest" / "optimizer.pt")
    assert all(g["step"] >= 1 for g in saved["param_groups"])
    assert saved["state"] and all(s["exp_avg_sq"].abs().sum() > 0
                                  for s in saved["state"].values())


def test_cli_cross_validation_folds(tmp_path, monkeypatch):
    """``--train_type cross --just_test``: ten folds of a moviescope
    fixture, each tested under its own run name (with a tiny BERT in place
    of BERT-base, which the CLI gives every jsonl task)."""
    to_config = cli.args_to_config

    def tiny_bert(args):
        exp = to_config(args)
        return exp.replace(model=exp.model.replace(
            bert=BertConfig.tiny(), orig_d_l=64))

    monkeypatch.setattr(cli, "args_to_config", tiny_bert)
    _write_task(tmp_path, "moviescope", n=20)
    argv = ["--task", "moviescope", "--data_path", str(tmp_path),
            "--model", "mmtrvapt", "--batch_sz", "4", "--num_vectors_l",
            "16", "--num_vectors_a", "8", "--num_vectors_v", "8",
            "--orig_d_v", "48", "--orig_d_a", "96",
            "--orig_d_p", "40", "--hidden_sz", "32", "--num_heads", "2",
            "--layers", "1", "--max_seq_len", "16", "--audio_raw_len", "400",
            "--video_len", "8", "--compute_dtype", "float32",
            "--device", "cpu",
            "--train_type", "cross", "--just_test", "--savedir",
            str(tmp_path / "runs"), "--name", "cv"]
    results = cli.cli_main(argv)
    assert sorted(results) == list(range(10))
    for k in range(10):
        assert (tmp_path / "runs" / f"cv_fold{k}" / "preds_raw.npy").exists()


@pytest.mark.parametrize("flags", [["--model", "gmu", "--hybrid"],
                                   ["--model", "bertclf", "--hybrid"]])
def test_unported_models_and_options_raise(tmp_path, flags):
    """A notebook-era model with ``--hybrid``, which the JAX package's
    notebook-era classes accept and ignore, trains and tests through the
    CLI: the option is saved with the run, and the model built is the one
    without it (no early-fusion encoders)."""
    import torch
    results = cli.cli_main(SMALL + flags + [
        "--max_epochs", "1", "--from_seed", "1", "--to_seed", "1",
        "--savedir", str(tmp_path), "--name", "ignored"])
    assert list(results) == [1] and "auc_pr_micro" in results[1]
    run = tmp_path / "ignored_Seed1_run"
    with open(run / "config.json") as f:
        saved = json.load(f)
    assert saved["model"]["hybrid"] and saved["model"]["model"] == flags[1]
    weights = torch.load(run / "latest" / "model.pt")["model"]
    assert weights and not any("early" in k for k in weights)


def test_module_help_exits_zero():
    res = subprocess.run([sys.executable, "-m", "bpx_torch.cli.train",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--device" in res.stdout and "--gradient_accumulation_steps" in \
        res.stdout
