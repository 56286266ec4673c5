"""The training loop (counterpart: ``bpx/train/loop.py``).

``train(exp)`` — the epoch loop:
* gradient accumulation over a super-batch stacked from A host batches;
* per-epoch validation; then, in this order, the plateau LR step, the new
  learning rate, the early-stopping update, and on improvement a checkpoint
  (``latest`` and its ``best`` mirror) carrying the epoch, the stopper and
  the plateau state;
* auto-resume from ``latest``: the epoch, the stopper, the plateau state,
  the learning rate, the weights, Adam's moments and the optimizer step;
* an optional ``torch.profiler`` trace and per-epoch throughput logging.

``test(exp)`` — restore ``best``, evaluate, write the prediction (and gate)
artifacts.  ``seed_sweep(exp)`` — the seed loop, runs named
``{name}_Seed{seed}_run``.

Dropout seeds: every optimizer step re-seeds the run's generator from
(run seed, step) (:func:`bpx_torch.ops.dropout.step_seed`), as the JAX
package folds ``state.step`` into its dropout key, so a resumed step draws
the masks the uninterrupted run would have drawn.  The loop moves each host
batch to the model's device itself; the loaders' prefetch thread only builds
numpy arrays.

Entry points run on ``device`` ("cuda" when None) and never fall back to
the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from bpx_torch.config import ExperimentConfig
from bpx_torch.data.loaders import get_data_loaders
from bpx_torch.models import get_model, resolve_device
from bpx_torch.ops.bert import maybe_load_pretrained
from bpx_torch.ops.dropout import step_seed
from bpx_torch.train.losses import make_loss_fn
from bpx_torch.train.metrics import compute_metrics, log_metrics, tuning_metric
from bpx_torch.train.optim import (EarlyStopping, PlateauScheduler,
                                   get_current_lr, make_optimizer, set_lr)
from bpx_torch.train.steps import make_eval_step, make_train_step
from bpx_torch.utils.artifacts import store_preds_to_disk
from bpx_torch.utils.checkpoint import CheckpointManager
from bpx_torch.utils.logging import create_logger
from bpx_torch.utils.profiling import StepTimer, trace
from bpx_torch.utils.seeding import set_seed


def _example_batch(loader):
    """Pull one batch (host-side)."""
    for batch in loader:
        return batch
    raise RuntimeError("empty loader")


def init_model_and_state(exp: ExperimentConfig, seed: int, device=None):
    """Build the model (weights drawn from ``seed``, BERT's from a local
    Hugging Face checkpoint when ``bert_init == "pretrained"``) and its
    optimizer; returns ``(model, optimizer)``."""
    model = get_model(exp.model, device=device, seed=seed)
    if exp.model.bert_init == "pretrained":
        model.load_state_dict(maybe_load_pretrained(
            model.state_dict(), exp.model.bert,
            exp.model.bert_weights_path))
    optimizer = make_optimizer(model.parameters(), exp.train.lr,
                               exp.train.optimizer)
    return model, optimizer


def _with_label_count(exp: ExperimentConfig, meta) -> ExperimentConfig:
    """The head sized by the label scan of train.jsonl, except for
    cmu-mosi, whose continuous labels would count distinct values: its
    regression head keeps the preset's one output."""
    if meta.n_classes != exp.model.n_classes and exp.data.task != "cmu-mosi":
        return exp.replace(model=exp.model.replace(n_classes=meta.n_classes))
    return exp


def _loss_fn(exp: ExperimentConfig, meta, train_data_len: int, device=None):
    d = exp.data
    return make_loss_fn(d.task, d.task_type, exp.train.weight_classes,
                        [meta.label_freqs[l] for l in meta.labels],
                        train_data_len, device=device)


def _to_device(batch: Dict[str, np.ndarray],
               device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _stack_accum(batches):
    """Stack A host batches into one (A, micro, ...) super-batch."""
    keys = [k for k in batches[0] if k != "valid"]
    return {k: np.stack([b[k] for b in batches]) for k in keys}


def evaluate(eval_step_fn, loader, task: str, task_type: str, device,
             loss_fn, collect_gates: bool = False):
    """No-grad eval loop -> (metrics, logits, targets, gates).

    The reported loss is ``loss_fn`` (a CPU one) on the host over the
    concatenated valid-sliced logits and targets, so the wrap-padded rows
    of the final partial batch are excluded.
    """
    all_logits, all_targets, all_gates = [], [], []
    for batch in loader:
        valid = batch.pop("valid", None)
        out = eval_step_fn(_to_device(batch, device))
        logits = out["logits"].float().cpu().numpy()
        n = logits.shape[0] if valid is None else int(valid.sum())
        all_logits.append(logits[:n])
        all_targets.append(np.asarray(batch["target"])[:n])
        if collect_gates and "gates" in out:
            all_gates.append(out["gates"].float().cpu().numpy()[:n])
    logits = np.concatenate(all_logits)
    targets = np.concatenate(all_targets)
    loss = float(loss_fn(torch.from_numpy(logits), torch.from_numpy(targets)))
    metrics = compute_metrics(task, task_type, logits, targets,
                              np.asarray([loss]))
    gates = np.concatenate(all_gates) if all_gates else None
    return metrics, logits, targets, gates


def train(exp: ExperimentConfig, data_all=None, partition_index=None,
          device=None) -> Dict[str, float]:
    device = resolve_device(device)
    tcfg, dcfg = exp.train, exp.data
    savedir = os.path.join(tcfg.savedir, tcfg.name)
    os.makedirs(savedir, exist_ok=True)
    logger = create_logger(os.path.join(savedir, "logfile.log"), exp)

    generator = set_seed(tcfg.seed)
    train_loader, val_loader, _, meta = get_data_loaders(
        dcfg, exp.model, seed=tcfg.seed, data_all=data_all,
        partition_index=partition_index)
    exp = _with_label_count(exp, meta)
    mcfg = exp.model
    loss_fn = _loss_fn(exp, meta, meta.train_data_len, device)
    host_loss_fn = _loss_fn(exp, meta, meta.train_data_len)

    # The JAX package pulls one batch here for its parameter shapes; that
    # iteration counts as a shuffle epoch, so the port pulls it too and
    # trains on the same orders.
    _example_batch(train_loader)
    model, optimizer = init_model_and_state(exp, tcfg.seed, device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("model %s: %.2fM params on %s", mcfg.model, n_params / 1e6,
                device)

    accum = max(1, tcfg.gradient_accumulation_steps)
    train_step = make_train_step(
        model, mcfg.model, loss_fn, optimizer, grad_accum=accum,
        freeze_bert=mcfg.freeze_bert, generator=generator,
        accum_dtype=tcfg.accum_dtype, accum_unroll=tcfg.accum_unroll,
        accum_scan_unroll=tcfg.accum_scan_unroll)
    # no device-side loss: evaluate() recomputes it on the host over the
    # valid-sliced concatenation (wrap-padded rows excluded)
    eval_step = make_eval_step(model, mcfg.model)

    mode = "min" if dcfg.task == "cmu-mosi" else "max"
    plateau = PlateauScheduler(lr=tcfg.lr, mode=mode, factor=tcfg.lr_factor,
                               patience=tcfg.lr_patience)
    stopper = EarlyStopping(patience=tcfg.patience, mode=mode)
    ckpt = CheckpointManager(savedir)
    ckpt.save_config(exp)

    start_epoch, step = 0, 0
    if ckpt.has_checkpoint("latest"):
        step, host = ckpt.restore(model, optimizer, "latest")
        start_epoch = int(host.get("epoch", 0))
        stopper.load_state_dict(host.get("stopper", stopper.state_dict()))
        plateau.load_state_dict(host.get("plateau", plateau.state_dict()))
        set_lr(optimizer, plateau.lr)
        logger.info("resumed from epoch %d (best %.4f)", start_epoch,
                    stopper.best)

    final_metrics: Dict[str, float] = {}
    with trace(tcfg.profile_dir):
        for epoch in range(start_epoch, tcfg.max_epochs):
            timer = StepTimer(device=device)
            epoch_losses, buffered = [], []
            n_samples = n_batches = 0
            data_s = 0.0
            t0 = time.perf_counter()
            batches = iter(train_loader)
            while True:
                t = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                batch.pop("valid", None)
                buffered.append(batch)
                n_batches += 1
                super_batch = None
                if len(buffered) == accum:
                    super_batch, buffered = _stack_accum(buffered), []
                data_s += time.perf_counter() - t
                if super_batch is None:
                    continue
                n_samples += (super_batch["txt"].shape[0]
                              * super_batch["txt"].shape[1])
                timer.start()
                generator.manual_seed(step_seed(tcfg.seed, step))
                step_metrics = train_step(_to_device(super_batch, device))
                step += 1
                epoch_losses.append(step_metrics["loss"])
                timer.stop()
            if not epoch_losses:
                raise RuntimeError(
                    f"epoch produced no optimizer steps: need at least "
                    f"{accum} batches of {dcfg.batch_sz}")
            train_loss = float(np.mean([float(l) for l in epoch_losses]))
            train_s = time.perf_counter() - t0
            logger.info("Epoch %d | Train Loss: %.4f | %.1f samples/s | "
                        "step %s | lr %.2e | data %.1f ms/batch",
                        epoch, train_loss, n_samples / max(train_s, 1e-9),
                        timer.summary(n_samples // len(epoch_losses)),
                        get_current_lr(optimizer),
                        data_s / max(n_batches, 1) * 1e3)

            t0 = time.perf_counter()
            metrics, *_ = evaluate(eval_step, val_loader, dcfg.task,
                                   dcfg.task_type, device, host_loss_fn)
            eval_s = time.perf_counter() - t0
            log_metrics(f"Val epoch {epoch}", metrics, dcfg.task, logger)

            tune = tuning_metric(dcfg.task, dcfg.task_type, metrics)
            set_lr(optimizer, plateau.step(tune))
            t0 = time.perf_counter()
            if stopper.update(tune):
                ckpt.save(model, optimizer, step,
                          {"epoch": epoch + 1,
                           "stopper": stopper.state_dict(),
                           "plateau": plateau.state_dict()},
                          is_best=True)
            logger.debug("epoch stats %s", json.dumps(dict(
                epoch=epoch, train_loss=train_loss, steps=len(epoch_losses),
                samples=n_samples, train_s=train_s,
                step_p50_s=timer.p50, data_s_per_batch=data_s / n_batches,
                eval_s=eval_s, checkpoint_s=time.perf_counter() - t0)))
            final_metrics = metrics
            if stopper.should_stop:
                logger.info("No improvement. Breaking out of loop.")
                break
    return final_metrics


def test(exp: ExperimentConfig, data_all=None, partition_index=None,
         device=None) -> Dict[str, float]:
    device = resolve_device(device)
    tcfg, dcfg = exp.train, exp.data
    savedir = os.path.join(tcfg.savedir, tcfg.name)
    os.makedirs(savedir, exist_ok=True)
    logger = create_logger(os.path.join(savedir, "logfileTest.log"), exp)

    set_seed(tcfg.seed)
    _, _, test_loader, meta = get_data_loaders(
        dcfg, exp.model, seed=tcfg.seed, data_all=data_all,
        partition_index=partition_index)
    exp = _with_label_count(exp, meta)
    host_loss_fn = _loss_fn(exp, meta, max(meta.train_data_len, 1))

    model, _ = init_model_and_state(exp, tcfg.seed, device)
    ckpt = CheckpointManager(savedir)
    if ckpt.has_checkpoint("best"):
        ckpt.restore(model, tag="best")
    else:
        logger.info("no best checkpoint found — evaluating fresh init")

    eval_step = make_eval_step(model, exp.model.model,
                               output_gates=tcfg.output_gates)
    metrics, logits, targets, gates = evaluate(
        eval_step, test_loader, dcfg.task, dcfg.task_type, device,
        host_loss_fn, collect_gates=tcfg.output_gates)
    log_metrics("Test", metrics, dcfg.task, logger)

    if dcfg.task_type == "multilabel":
        raw = 1.0 / (1.0 + np.exp(-logits))
        preds = (raw > 0.5).astype(np.int64)
    else:
        raw = logits
        preds = logits.argmax(-1) if logits.shape[-1] > 1 else logits[:, 0]
    store_preds_to_disk(targets, preds, savedir, meta.labels,
                        dcfg.task_type, preds_raw=raw, gates=gates)
    return metrics


def seed_sweep(exp: ExperimentConfig,
               device=None) -> Dict[int, Dict[str, float]]:
    """Train (unless ``just_test``) and test one run per seed of
    ``from_seed..to_seed`` (reversed with ``inverse_seed``)."""
    results = {}
    base_name = exp.train.name
    for i in range(exp.train.from_seed, exp.train.to_seed + 1):
        seed = (exp.train.to_seed + 1 - i) if exp.train.inverse_seed else i
        run = exp.replace(train=dataclasses.replace(
            exp.train, seed=seed,
            name=f"{base_name}_Seed{seed}_run"))
        if not exp.train.just_test:
            train(run, device=device)
        results[seed] = test(run, device=device)
    return results
