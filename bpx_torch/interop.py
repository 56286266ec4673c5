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
  ``layers.0 .. layers.{L-1}``; unrolled ``layer{i}`` becomes ``layers.{i}``.

A leaf with no rule, and any key that the model has and the tree lacks or the
other way round, raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from bpx_torch.config import ModelConfig

_UNROLLED = re.compile(r"^layer(\d+)$")


def _leaf(path, name: str, value: np.ndarray):
    """(torch leaf name, array) for one flax leaf."""
    parent = path[-1] if path else ""
    if name == "kernel":
        if parent.startswith("transfm_"):
            return "weight", value
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
                    depth = _stack_depth(value)
                    for i in range(depth):
                        walk(_index(value, i), path + [key],
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


def _stack_depth(node: Mapping) -> int:
    depths = {leaf.shape[0] for leaf in _leaves(node)}
    if len(depths) != 1:
        raise ValueError(f"scanned subtree has mixed leading dims {depths}")
    return depths.pop()


def _index(node: Mapping, i: int) -> Dict:
    return {k: (_index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i])
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
