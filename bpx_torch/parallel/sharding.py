"""The model, its state and the batch on the ``(data, fsdp, tensor)`` mesh
(counterpart: ``bpx/parallel/sharding.py`` and the placement helpers of
``bpx/train/steps.py``).

The JAX package states a ``NamedSharding`` per parameter and lets GSPMD
insert the collectives.  The port runs one process per rank and places by
hand, in three layers:

* **tensor** — Megatron's split, done on the module's own weights: a
  column-parallel ``nn.Linear`` (``_COLUMN_PARALLEL``) keeps its rank's
  output rows, a row-parallel one (``_ROW_PARALLEL``) its input columns,
  and its partial sums are added over the ``tensor`` group
  (``collectives.leave_split``) before the bias; the input of a
  column-parallel product passes ``collectives.enter_split``, whose
  backward adds the input's gradient over the group.  Each rank holds
  plain local tensors: the custom ops (``bpx_torch::flash_fwd``,
  ``flash_bwd``, ``layer_norm``) have no DTensor sharding rule, and the
  attention concatenates its q/k/v weights into one product
  (``ops/attention.py::fused_projection``), so ``parallelize_module`` is
  not used.  A layer splits only where ``tensor`` divides its width and,
  for an attention, its head count; otherwise it replicates, as
  ``_fit_spec_to_mesh`` replicates hidden 300 on an 8-way group.  The
  attention and the FFN of one layer decide apart: 12 heads of 300 on 8
  ranks replicate, while the FFN's 1200 columns split;
* **fsdp** — FSDP2's ``fully_shard`` over the ``(data, fsdp)`` sub-mesh
  (HSDP: sharded over ``fsdp``, replicated over ``data``), one unit per
  encoder and BERT layer and the root for the rest; where ``fsdp`` is 1,
  plain ``DistributedDataParallel`` over the ``data`` group.  A grouped
  pair's parameters, whose dim 0 is the pair axis of 2, shard on their
  next dim (:func:`pair_placement`), so that no rank of more than two
  holds an empty shard;
* **data** — :func:`place_batch` gives each rank its rows of the micro
  axis over ``(data, fsdp)``; the step's loss and the dropout hashes see
  where those rows sit in the global batch.

Of the JAX package's column-parallel names the port replicates ``x_gate``,
``x_gates`` (the GMUs' gates) and ``hidden1`` to ``hidden5`` (the N-ary
GMU's per-input projections): their outputs feed elementwise gates and
sums over the full hidden width, so a split would all-gather each of them
again right away, and the step's numbers, not the JAX package's
placement, are what must match.  The audio conv (the JAX package's 3-D
``(K, Cin, Cout)`` kernels on ``tensor``) replicates for the same reason.
Every embedding, LayerNorm and bias replicates over ``tensor``; FSDP2
shards all of them over ``fsdp``.

The JAX package's ``constrain``, ``constrain_heads`` and
``constrain_like_params`` pin GSPMD's layouts inside a traced step; the
port traces nothing and places every tensor itself, so they have no
counterpart.

``group_encoders``' pairs split as the encoders they stack do: each
member's heads and FFN over ``tensor`` (the weights' dims after the pair
axis), each pair LayerNorm whole.  The notebook-era models' encoders and
BERT layers split as BPMulT's; their GMU layers and BERT's pooler stay
whole on every rank, as the BPMulT models' GMUs do.  A model holding a
module type that is not in :data:`SPLIT_TYPES` (none that the registry
builds) raises under ``tensor > 1``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from bpx_torch.models.bpmult import BPMulTVAPT, BPMulTVAT, SeqAdapter
from bpx_torch.models.legacy import (BertClf, GMUBimodalClf, GMUClf,
                                     MulTGMUClf, TranslatingMMTGMUClf)
from bpx_torch.ops.attention import MultiheadAttention
from bpx_torch.ops.audio import AudioEncoder, Conv1d
from bpx_torch.ops.bert import (BertEncoder, BertLayer, BertSelfAttention,
                                _Embedding)
from bpx_torch.ops.encoder import (GroupedTransformerEncoder, PairAttention,
                                   PairEncoderLayer, PairLayerNorm,
                                   PairLinear, TransformerEncoder,
                                   TransformerEncoderLayer)
from bpx_torch.ops.gmu import (GatedBimodalFusionLayer, GatedBimodalLayer,
                               GatedHierarchicalLayer, GatedNModalLayer,
                               GatedSoftmaxLayer)
from bpx_torch.ops.mag import MAG
from bpx_torch.ops.norm import LayerNorm
from bpx_torch.parallel.collectives import TensorSplit

# Linear layers whose OUTPUT features split over ``tensor`` (the JAX
# package's list; the port splits the attention's and the FFN's, see the
# module docstring for the rest)
_COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "query", "key", "value",
                    "fc1", "intermediate", "x_gate", "x_gates", "hidden1",
                    "hidden2", "hidden3", "hidden4", "hidden5")
# Linear layers whose INPUT features split over ``tensor``
_ROW_PARALLEL = ("out_proj", "fc2", "attention_output", "output")

#: the module types a model under the tensor split may hold: those it
#: cuts (``split_plan``: the attentions, encoder and BERT layers, and
#: their pair forms), those it keeps whole on every rank (the GMU layers
#: among them), and the models of the registry, whose forwards run each
#: cut module whole through its own forward and read no head count or
#: width of one.  Anything else (a module added later) raises until the
#: split is held against one process for it.
SPLIT_TYPES = (MultiheadAttention, TransformerEncoderLayer, BertLayer,
               PairAttention, PairEncoderLayer, nn.Linear, PairLinear,
               nn.ModuleList, LayerNorm, PairLayerNorm, _Embedding,
               BertSelfAttention, BertEncoder, TransformerEncoder,
               GroupedTransformerEncoder, AudioEncoder, Conv1d,
               GatedBimodalFusionLayer, GatedNModalLayer, GatedBimodalLayer,
               GatedHierarchicalLayer, GatedSoftmaxLayer, MAG, SeqAdapter,
               BPMulTVAPT, BPMulTVAT, MulTGMUClf, TranslatingMMTGMUClf,
               GMUClf, GMUBimodalClf, BertClf)


def unsplit_types(model: nn.Module) -> List[str]:
    """The names of ``model``'s module types the tensor split does not
    take (:data:`SPLIT_TYPES`; a subclass such as ``PairAttention`` is
    not taken for its base)."""
    return sorted({type(m).__name__ for m in model.modules()
                   if type(m) not in SPLIT_TYPES})


def parallel_kind(name: str) -> Optional[str]:
    """"column", "row" or None for a linear layer's attribute name."""
    if name in _COLUMN_PARALLEL:
        return "column"
    if name in _ROW_PARALLEL:
        return "row"
    return None


def _split_linear(parent: str, layer: nn.Linear, attr: str,
                  split: TensorSplit, record: Dict[str, int]) -> None:
    """Keep the rank's part of ``layer`` (an ``nn.Linear``, or a pair's
    :class:`PairLinear`, whose dims follow its pair axis): output rows
    (and bias) of a column-parallel layer, input columns of a row-parallel
    one (its bias whole).  Records each split parameter's name and dim."""
    kind = parallel_kind(attr)
    if kind is None:
        raise ValueError(f"{attr} is neither column- nor row-parallel")
    lead = layer.weight.dim() - 2
    dim = lead + (0 if kind == "column" else 1)
    off, n = split.part(layer.weight.shape[dim])
    for pname, d in (("weight", dim), ("bias", lead)):
        p = getattr(layer, pname)
        if p is None or (pname == "bias" and kind == "row"):
            continue
        setattr(layer, pname, nn.Parameter(
            p.detach().narrow(d, off, n).clone(),
            requires_grad=p.requires_grad))
        record[f"{parent}.{attr}.{pname}" if parent else
               f"{attr}.{pname}"] = d


def split_plan(model: nn.Module, tensor: int) -> Dict[str, Tuple[str, ...]]:
    """Which modules a ``tensor``-way split splits: module name -> its
    parts that split, "heads" (an attention, or a BERT layer's attention)
    and "ffn" (an encoder or BERT layer's FFN); absent modules
    replicate."""
    plan = {}
    for name, m in model.named_modules():
        if isinstance(m, MultiheadAttention):
            heads, width, inner = m.num_heads, m.embed_dim, None
        elif isinstance(m, TransformerEncoderLayer):
            heads = width = None
            inner = m.fc1.weight.shape[-2]
        elif isinstance(m, BertLayer):
            heads, width = m.cfg.num_heads, m.cfg.hidden_size
            inner = m.cfg.intermediate_size
        else:
            continue
        parts = tuple(
            part for part, ok in (
                ("heads", heads is not None and heads % tensor == 0
                 and width % tensor == 0),
                ("ffn", inner is not None and inner % tensor == 0)) if ok)
        if parts:
            plan[name] = parts
    return plan


# the linear layers of each splittable part: (submodule path, attribute)
_PARTS = {
    (MultiheadAttention, "heads"): (("", "q_proj"), ("", "k_proj"),
                                    ("", "v_proj"), ("", "out_proj")),
    (TransformerEncoderLayer, "ffn"): (("", "fc1"), ("", "fc2")),
    (BertLayer, "heads"): (("attention", "query"), ("attention", "key"),
                           ("attention", "value"), ("", "attention_output")),
    (BertLayer, "ffn"): (("", "intermediate"), ("", "output")),
}


def split_tensor(model: nn.Module, split: TensorSplit) -> Dict[str, int]:
    """Split ``model``'s layers over ``split``'s group in place, by
    :func:`split_plan`; returns {parameter name: split dim}.  A split
    attention keeps ``num_heads`` of its rank and its ``split``; a split
    FFN its ``ffn_split``."""
    record: Dict[str, int] = {}
    modules = dict(model.named_modules())
    for name, parts in split_plan(model, split.size).items():
        m = modules[name]
        kind = next(t for t in (MultiheadAttention, TransformerEncoderLayer,
                                BertLayer) if isinstance(m, t))
        for part in parts:
            for sub, attr in _PARTS[kind, part]:
                parent = m.get_submodule(sub) if sub else m
                path = ".".join(p for p in (name, sub) if p)
                _split_linear(path, getattr(parent, attr), attr, split,
                              record)
            if part == "heads":
                m.num_heads //= split.size
                m.split = split
            else:
                m.ffn_split = split
    return record


def mesh_sizes(mesh) -> Tuple[int, int, int]:
    """(data, fsdp, tensor) of a mesh."""
    return tuple(int(s) for s in mesh.shape)


def unwrap(model: nn.Module) -> nn.Module:
    """The model inside a ``DistributedDataParallel`` wrapper."""
    from torch.nn.parallel import DistributedDataParallel
    return model.module if isinstance(model, DistributedDataParallel) \
        else model


def pair_placement(model: nn.Module, fsdp: int):
    """FSDP2's ``shard_placement_fn`` for ``model``: ``Shard(1)`` for a
    grouped pair's parameters (dim 0 the pair axis of 2) where ``fsdp``
    divides dim 1, else None (FSDP2's ``Shard(0)``); None for a model
    without pairs."""
    from torch.distributed.tensor import Shard
    pairs = {id(p) for m in model.modules()
             if isinstance(m, (PairLinear, PairLayerNorm))
             for p in m.parameters(recurse=False)}
    if not pairs:
        return None

    def place(p):
        if id(p) in pairs and p.dim() > 1 and p.shape[1] % fsdp == 0:
            return Shard(1)
        return None
    return place


def shard_model(model: nn.Module, mesh, use_fsdp: Optional[bool] = None
                ) -> nn.Module:
    """Place ``model`` on ``mesh``: the tensor split, then FSDP2 over
    ``(data, fsdp)`` (``use_fsdp``, default ``fsdp > 1``) or else DDP over
    ``data``; returns the module to train (the DDP wrapper, or the model
    itself, FSDP2 working in place).  Build the optimizer after this, so
    that its moments are sharded with their weights.  The model's
    ``tensor_split`` lists the parameters the split cut ({name: dim}), its
    ``tensor_group`` is the rank's :class:`TensorSplit` (None at tensor
    1)."""
    data, fsdp, tensor = mesh_sizes(mesh)
    model.tensor_split, model.tensor_group = {}, None
    if tensor > 1:
        unknown = unsplit_types(model)
        if unknown:
            raise NotImplementedError(
                f"the tensor split does not take {', '.join(unknown)}")
        split = TensorSplit(mesh.get_group("tensor"),
                            mesh.get_local_rank("tensor"), tensor)
        model.tensor_split = split_tensor(model, split)
        model.tensor_group = split
    if use_fsdp is None:
        use_fsdp = fsdp > 1
    if use_fsdp:
        from torch.distributed.fsdp import fully_shard
        dp = mesh["data", "fsdp"]
        kw = dict(mesh=dp, shard_placement_fn=pair_placement(model, fsdp))
        for m in model.modules():
            if isinstance(m, (TransformerEncoderLayer, BertLayer)):
                fully_shard(m, **kw)
        fully_shard(model, **kw)
        return model
    from torch.nn.parallel import DistributedDataParallel
    ids = ([torch.cuda.current_device()] if mesh.device_type == "cuda"
           else None)
    return DistributedDataParallel(model, device_ids=ids,
                                   process_group=mesh.get_group("data"))


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------

def batch_rows(mesh) -> Tuple[int, int]:
    """(index, count) of this rank among the ``(data, fsdp)`` ranks that
    split the batch, data-major as the JAX package's ``P(("data",
    "fsdp"))`` lays it out."""
    data, fsdp, _ = mesh_sizes(mesh)
    return (mesh.get_local_rank("data") * fsdp
            + mesh.get_local_rank("fsdp"), data * fsdp)


def place_batch(batch: Dict, mesh, has_accum_axis: bool = True):
    """This rank's rows of the micro axis (axis 1 of an (A, micro, ...)
    super-batch, else axis 0) over ``(data, fsdp)``: (local batch, (row
    offset, global rows)).  Raises where the rows do not divide."""
    index, count = batch_rows(mesh)
    axis = 1 if has_accum_axis else 0
    sizes = {v.shape[axis] for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"batch arrays disagree on axis {axis}: {sizes}")
    rows = sizes.pop()
    if rows % count:
        raise ValueError(f"{rows} batch rows do not split over {count} "
                         f"(data, fsdp) ranks")
    n = rows // count
    sl = (slice(None),) * axis + (slice(index * n, (index + 1) * n),)
    return {k: v[sl] for k, v in batch.items()}, (index * n, rows)


def dp_groups(mesh) -> List[object]:
    """The process groups of ``data`` and ``fsdp`` of more than one rank:
    a sum over each in turn is the sum over the ranks that split the
    batch."""
    data, fsdp, _ = mesh_sizes(mesh)
    return [mesh.get_group(n) for n, s in (("fsdp", fsdp), ("data", data))
            if s > 1]


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ``(data, fsdp)`` ranks' row blocks of ``x`` concatenated in
    rank order (the inverse of :func:`place_batch` at axis 0)."""
    data, fsdp, _ = mesh_sizes(mesh)
    for name, size in (("fsdp", fsdp), ("data", data)):
        if size > 1:
            parts = [torch.empty_like(x) for _ in range(size)]
            dist.all_gather(parts, x.contiguous(),
                            group=mesh.get_group(name))
            x = torch.cat(parts)
    return x


# ---------------------------------------------------------------------------
# the state: whole tensors in, whole tensors out
# ---------------------------------------------------------------------------

def _whole(t: torch.Tensor, dim: Optional[int], split) -> torch.Tensor:
    """A parameter-shaped tensor made whole: a DTensor's full tensor, then
    the tensor group's parts along ``dim``; a detached CPU copy."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if dim is not None and split is not None:
        parts = [torch.empty_like(t) for _ in range(split.size)]
        dist.all_gather(parts, t.detach().contiguous(), group=split.group)
        t = torch.cat(parts, dim)
    return t.detach().to("cpu", copy=True)


def _part(full: torch.Tensor, like: torch.Tensor, dim: Optional[int],
          split) -> torch.Tensor:
    """The rank's part of a whole tensor, laid out as ``like`` is: the
    tensor group's part along ``dim``, then a DTensor's shard."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if dim is not None and split is not None:
        off, n = split.part(full.shape[dim])
        full = full.narrow(dim, off, n)
    if isinstance(like, DTensor):
        full = full.to(device=like.device, dtype=like.dtype)
        try:    # every rank read the same file: shard locally
            return distribute_tensor(full, like.device_mesh, like.placements,
                                     src_data_rank=None)
        except TypeError:
            return distribute_tensor(full, like.device_mesh, like.placements)
    return full.to(device=like.device, dtype=like.dtype)


def _param_names(model: nn.Module, optimizer) -> List[str]:
    """The names of the optimizer's parameters, in its state dict's
    index order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _param_shaped(v, p) -> bool:
    return isinstance(v, torch.Tensor) and v.dim() > 0 and v.dim() == p.dim()


def full_model_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's whole state dict on the CPU, whatever its placement;
    collective on a mesh (every rank calls it, every rank gets it)."""
    inner = unwrap(model)
    split_dims = getattr(inner, "tensor_split", {})
    split = getattr(inner, "tensor_group", None)
    return {n: _whole(v, split_dims.get(n), split)
            for n, v in inner.state_dict().items()}


def full_gradients(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Each parameter's whole gradient (FSDP2's shards and the tensor
    split's parts put together), on its device; collective as
    :func:`full_model_state`.  A parameter without a gradient is left
    out."""
    from torch.distributed.tensor import DTensor
    inner = unwrap(model)
    split_dims = getattr(inner, "tensor_split", {})
    split = getattr(inner, "tensor_group", None)
    out = {}
    for n, p in inner.named_parameters():
        g = p.grad
        if g is None:
            continue
        if isinstance(g, DTensor):
            g = g.full_tensor()
        dim = split_dims.get(n)
        if dim is not None and split is not None:
            parts = [torch.empty_like(g) for _ in range(split.size)]
            dist.all_gather(parts, g.contiguous(), group=split.group)
            g = torch.cat(parts, dim)
        out[n] = g
    return out


def full_optimizer_state(model: nn.Module, optimizer) -> Dict:
    """The optimizer's state dict (index-keyed, as one process's) with
    every moment whole, on the CPU; collective as
    :func:`full_model_state`."""
    inner = unwrap(model)
    split_dims = getattr(inner, "tensor_split", {})
    split = getattr(inner, "tensor_group", None)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    names = _param_names(inner, optimizer)
    sd = optimizer.state_dict()
    state = {}
    for idx in sorted(sd["state"]):
        p, name = params[idx], names[idx]
        state[idx] = {k: (_whole(v, split_dims.get(name), split)
                          if _param_shaped(v, p) else
                          v.detach().to("cpu", copy=True)
                          if isinstance(v, torch.Tensor)
                          else v)
                      for k, v in sd["state"][idx].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def load_full_model_state(model: nn.Module,
                          state: Dict[str, torch.Tensor]) -> None:
    """Load a whole state dict (one process's, or :func:`full_model_state`)
    into ``model`` wherever it is placed."""
    inner = unwrap(model)
    split_dims = getattr(inner, "tensor_split", {})
    split = getattr(inner, "tensor_group", None)
    current = inner.state_dict()
    missing = set(current) ^ set(state)
    if missing:
        raise KeyError(f"state dict keys differ: {sorted(missing)[:8]}")
    inner.load_state_dict({n: _part(state[n], cur, split_dims.get(n), split)
                           for n, cur in current.items()}, strict=True)


def load_full_optimizer_state(model: nn.Module, optimizer,
                              state: Dict) -> None:
    """Load a whole optimizer state dict into the optimizer of a placed
    model: each moment cut and sharded as its parameter is."""
    inner = unwrap(model)
    split_dims = getattr(inner, "tensor_split", {})
    split = getattr(inner, "tensor_group", None)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    names = _param_names(inner, optimizer)
    placed = {}
    for idx, entry in state["state"].items():
        p, name = params[int(idx)], names[int(idx)]
        placed[idx] = {k: (_part(v, p, split_dims.get(name), split)
                           .to(v.dtype) if _param_shaped(v, p) else v)
                       for k, v in entry.items()}
    optimizer.load_state_dict({"state": placed,
                               "param_groups": state["param_groups"]})


def param_count(model: nn.Module) -> int:
    """The model's parameters, counted whole wherever they are placed."""
    inner = unwrap(model)
    split = getattr(inner, "tensor_group", None)
    cut = getattr(inner, "tensor_split", {})
    return sum(p.numel() * (split.size if split is not None and n in cut
                            else 1)
               for n, p in inner.named_parameters())


def sharded(model: nn.Module) -> bool:
    """True when the model's state is spread over ranks (a process group
    of more than one rank, or a DTensor parameter)."""
    from torch.distributed.tensor import DTensor
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return True
    return any(isinstance(p, DTensor) for p in model.parameters())


def grad_sq_norm(model: nn.Module, params: Sequence[torch.Tensor], mesh
                 ) -> torch.Tensor:
    """The squared norm of the whole gradient: each rank's squares summed
    once over the ranks that hold different parts of it (the tensor
    group for the split parameters, then the fsdp group for FSDP2's
    shards), each replicated weight counted once."""
    from torch.distributed.tensor import DTensor
    inner = unwrap(model)
    split_names = set(getattr(inner, "tensor_split", {}))
    names = {id(p): n for n, p in inner.named_parameters()}
    dev = next(iter(params)).device if params else torch.device("cpu")
    cut = torch.zeros((), dtype=torch.float32, device=dev)
    whole = torch.zeros((), dtype=torch.float32, device=dev)
    fsdp_sharded = False
    for p in params:
        g = p.grad
        if g is None:
            continue
        if isinstance(g, DTensor):
            fsdp_sharded = True
            g = g.to_local()
        sq = g.float().pow(2).sum()
        if names.get(id(p)) in split_names:
            cut = cut + sq
        else:
            whole = whole + sq
    split = getattr(inner, "tensor_group", None)
    if split is not None:
        dist.all_reduce(cut, group=split.group)
    total = cut + whole
    if fsdp_sharded and mesh_sizes(mesh)[1] > 1:
        dist.all_reduce(total, group=mesh.get_group("fsdp"))
    return total
