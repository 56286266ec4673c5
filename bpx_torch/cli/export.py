"""Export a run directory of the port's trainer as a serving archive
(counterpart: ``bpx/cli/export.py``).

It restores the run's best (or latest) checkpoint through
:meth:`bpx_torch.serve.Predictor.from_checkpoint`, traces the serving
forward (the model and the task's sigmoid or softmax, with the gates) once
at a fixed batch size with ``torch.export``, and writes the archive with the
weights inside.  :class:`bpx_torch.serve.ExportedPredictor` serves it with
torch and ``bpx_torch.ops`` alone: no model code, config, checkpoint or
dataset on the serving host.

Usage::

    python -m bpx_torch.cli.export runs/moviescope/run_Seed1_run \\
        --out model.pt2 --batch_size 8 [--tag best|latest] [--device cuda]

The run directory holds the ``config.json`` snapshot and the ``best`` and
``latest`` checkpoints the trainer writes.  The example batch the forward is
traced on is made from the config's shapes, so the dataset need not be
present.  ``--device`` (``cuda`` by default; ``cpu`` runs the plain
versions) is where the program is traced and so where it is served.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> str:
    p = argparse.ArgumentParser(
        description="export a trained run as a torch.export serving archive")
    p.add_argument("run_dir", help="run directory (config.json and the "
                                   "best/latest checkpoints)")
    p.add_argument("--out", default=None,
                   help="archive path (default: <run_dir>/model.pt2)")
    p.add_argument("--batch_size", type=int, default=8,
                   help="traced serving batch size (clients may send "
                        "fewer rows; they are padded and sliced)")
    p.add_argument("--tag", default="best", choices=["best", "latest"])
    p.add_argument("--device", default="cuda",
                   help="device the program is traced and served on")
    args = p.parse_args(argv)

    with open(os.path.join(args.run_dir, "config.json")) as f:
        snapshot = json.load(f)

    from bpx_torch.config import config_from_dict
    from bpx_torch.data.synthetic import example_batch
    from bpx_torch.serve import Predictor

    exp = config_from_dict(snapshot)
    batch = example_batch(exp, args.batch_size)
    pred = Predictor.from_checkpoint(exp, args.run_dir,
                                     batch_size=args.batch_size, tag=args.tag,
                                     device=args.device)
    out = args.out or os.path.join(args.run_dir, "model.pt2")
    blob = pred.export(batch, out)
    sys.stderr.write(
        f"exported {exp.model.model} ({args.tag}, batch {args.batch_size}, "
        f"{args.device}) -> {out} ({len(blob) / 1e6:.1f} MB)\n")
    return out


if __name__ == "__main__":
    main()
