"""Carry the JAX package's parameters into the port.

:func:`params_from_flax` takes the flax parameter tree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX side) and
returns a state dict of the port's model; nothing here imports jax.

Mapping, leaf by leaf:

* Dense ``kernel (in, out)`` -> ``weight (out, in)``;
* ``GemmConv1d kernel (K, Cin, Cout)`` -> ``weight (Cout, Cin, K)``;
* ``SeqAdapter`` (``transfm_*``) ``kernel (T_out, T_in)`` -> ``weight`` as is;
* LayerNorm ``scale`` -> ``weight``; ``nn.Embed`` ``embedding`` -> ``weight``;
* ``bias`` -> ``bias``;
* an ``nn.scan``-stacked ``layers`` subtree (leaves ``(L, ...)``) is split into
  ``layers.0 .. layers.{L-1}``; unrolled ``layer{i}`` becomes ``layers.{i}``;
* a grouped encoder pair (``g_va`` ... ``g_xl2``, ``group_encoders``) has
  the pair axis of 2 in front of every leaf, before the scanned layer
  axis: its Dense ``kernel (2, in, out)`` becomes ``weight (2, out, in)``,
  its scanned leaves ``(2, L, ...)`` split over axis 1, the rest keep the
  pair axis.

The rules cover both models' trees: mmtrvapt's, and mmtrvat's (no poster,
no ``transfm_*``; a 3-ary ``gmu``, or ``mag`` with its Dense layers and
``mag/norm``), with ``hybrid`` (``trans_*_early``, ``proj_*_e``, whose
Dense kernel (T, reduced_dim) becomes ``weight (reduced_dim, T)``,
``gmu_early``) and with ``group_encoders``; and the notebook-era models'
trees, whose new leaves are Dense kernels and biases (BERT's ``pooler``,
the GMU variants' ``x1_gate``, ``x2_gate`` and ``transform_i``, the
``hidden_i`` and ``x_gates`` of a GMU over 2E-wide inputs, ``out_layer``
and ``clf``) and whose memory encoders are unrolled encoders.  A leaf with
no rule, and any key that the model has and the tree lacks or the other
way round, raises.
:func:`stacked_params_from_flax` carries the multi-seed tree (a leading
seed axis on every leaf) into the multi-seed state's stacked parameters.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from bpx_torch.config import ModelConfig

_UNROLLED = re.compile(r"^layer(\d+)$")
#: the grouped encoder pairs of ``group_encoders``
GROUPED = ("g_va", "g_xl", "g_lx", "g_l_bi", "g_x2l", "g_xl2")


def _leaf(path, name: str, value: np.ndarray):
    """(torch leaf name, array) for one flax leaf."""
    parent = path[-1] if path else ""
    if name == "kernel":
        if parent.startswith("transfm_"):
            return "weight", value
        if path and path[0] in GROUPED and value.ndim == 3:
            return "weight", np.swapaxes(value, 1, 2)
        if value.ndim == 3:
            return "weight", np.transpose(value, (2, 1, 0))
        if value.ndim == 2:
            return "weight", value.T
    elif name in ("scale", "embedding"):
        return "weight", value
    elif name == "bias":
        return "bias", value
    raise KeyError(f"no rule for flax leaf {'/'.join(path + [name])} "
                   f"of shape {value.shape}")


def flax_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Convert a flax parameter (sub)tree of numpy arrays to torch names and
    layouts; no check against a model (see :func:`params_from_flax`)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path, torch_path):
        for key, value in node.items():
            if isinstance(value, Mapping):
                m = _UNROLLED.match(key)
                if key == "layers":
                    # a grouped pair's layer axis follows its pair axis
                    axis = int(bool(path) and path[0] in GROUPED)
                    depth = _stack_depth(value, axis)
                    for i in range(depth):
                        walk(_index(value, i, axis), path + [key],
                             torch_path + ["layers", str(i)])
                elif m:
                    walk(value, path + [key],
                         torch_path + ["layers", m.group(1)])
                else:
                    walk(value, path + [key], torch_path + [key])
                continue
            name, arr = _leaf(path, key, np.asarray(value))
            out[".".join(torch_path + [name])] = torch.tensor(
                np.asarray(arr, dtype=np.float32))

    walk(tree, [], [])
    return out


def _leaves(node: Mapping):
    for value in node.values():
        if isinstance(value, Mapping):
            yield from _leaves(value)
        else:
            yield np.asarray(value)


def _stack_depth(node: Mapping, axis: int = 0) -> int:
    depths = {leaf.shape[axis] for leaf in _leaves(node)}
    if len(depths) != 1:
        raise ValueError(f"scanned subtree has mixed layer dims {depths}")
    return depths.pop()


def _index(node: Mapping, i: int, axis: int = 0) -> Dict:
    return {k: (_index(v, i, axis) if isinstance(v, Mapping)
                else np.take(np.asarray(v), i, axis=axis))
            for k, v in node.items()}


def params_from_flax(tree: Mapping, cfg: ModelConfig
                     ) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``cfg.model`` from the JAX package's
    parameter tree (the ``params`` collection, numpy leaves).  Raises if
    a leaf has no rule, a key is unmatched or left over, or a shape
    differs."""
    from bpx_torch.models import get_model

    sd = flax_to_state_dict(tree)
    want = get_model(cfg, device="meta").state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"flax tree does not match the model: missing "
                       f"{missing[:8]}{'...' if len(missing) > 8 else ''}, "
                       f"left over {extra[:8]}"
                       f"{'...' if len(extra) > 8 else ''}")
    bad = [k for k in want if tuple(want[k].shape) != tuple(sd[k].shape)]
    if bad:
        raise ValueError("shape mismatch: " + ", ".join(
            f"{k} {tuple(sd[k].shape)} vs {tuple(want[k].shape)}"
            for k in bad[:8]))
    return sd


def stacked_params_from_flax(tree: Mapping, cfg: ModelConfig
                             ) -> Dict[str, torch.Tensor]:
    """The multi-seed state's stacked parameters (``train/multiseed.py``)
    from the JAX package's multi-seed tree, which has a leading seed axis
    on every leaf: each seed's tree through :func:`params_from_flax`, so a
    leftover or unmatched key still raises, then stacked."""
    per_seed = [params_from_flax(_index(tree, s), cfg)
                for s in range(_stack_depth(tree))]
    return {k: torch.stack([sd[k] for sd in per_seed]) for k in per_seed[0]}
