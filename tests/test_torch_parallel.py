"""The port's mesh, sharding rules and block placement, in one process
(counterparts of ``tests/test_distributed.py``'s ``test_make_mesh_shapes``,
``test_sharding_rules`` and ``test_spec_fitting_to_mesh``).

* the mesh layout of a world, ``data=-1`` absorbing the remainder, and a
  layout that does not divide the world raising;
* which layers a tensor split cuts: every attention and FFN of the tiny
  model at 2 ways; at hidden 300 over 12 heads on 8 ways the attentions
  replicate (12 heads do not split 8 ways) while the FFN's 1200 columns
  split, as the JAX package's ``_fit_spec_to_mesh`` decides per weight;
  the parts two ranks keep put the weights back together;
* ``place_batch``'s rows, data-major over ``(data, fsdp)``;
* the block placement: a piece's flash mask (``keep_mask``) and hash mask
  (``hash_keep``) equal the global mask's slice bit for bit at data, tensor
  and data x tensor pieces, with one seed group and two; the default
  placement leaves every mask as it was; a placed plain flash call's
  output and gradients equal the global call's slice.

The multi-process steps are in ``tests/test_torch_distributed*.py``.
"""

import dataclasses
import pathlib

import pytest
import torch

from bpx_torch.config import MeshConfig, get_preset
from bpx_torch.models import get_model
from bpx_torch.ops.dropout import block_place, hash_keep
from bpx_torch.ops.flash_attention import (flash_attention,
                                           flash_attention_backward, keep_mask)
from bpx_torch.parallel import sharding
from bpx_torch.parallel.collectives import TensorSplit
from bpx_torch.parallel.mesh import mesh_shape

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_make_mesh_shapes():
    assert mesh_shape(MeshConfig(data=-1, fsdp=1, tensor=1), 8) == (8, 1, 1)
    assert mesh_shape(MeshConfig(data=2, fsdp=2, tensor=2), 8) == (2, 2, 2)
    assert mesh_shape(MeshConfig(data=-1, fsdp=2, tensor=2), 8) == (2, 2, 2)
    assert mesh_shape(MeshConfig(), 1) == (1, 1, 1)
    with pytest.raises(ValueError, match="3x1x1 != 8"):
        mesh_shape(MeshConfig(data=3, fsdp=1, tensor=1), 8)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_shape(MeshConfig(data=-1, fsdp=3, tensor=1), 8)


def test_sharding_rules():
    assert sharding.parallel_kind("fc1") == "column"
    assert sharding.parallel_kind("q_proj") == "column"
    assert sharding.parallel_kind("intermediate") == "column"
    assert sharding.parallel_kind("out_proj") == "row"
    assert sharding.parallel_kind("attention_output") == "row"
    assert sharding.parallel_kind("ln0") is None
    assert sharding.parallel_kind("word_embeddings") is None


def _tiny():
    exp = get_preset("synthetic-tiny")
    return exp.model.replace(hidden_sz=32, num_heads=2, layers=1,
                             num_vectors_l=16, num_vectors_a=8,
                             num_vectors_v=8, orig_d_l=64)


def test_split_plan_of_the_tiny_model():
    model = get_model(_tiny(), device="meta")
    plan = sharding.split_plan(model, 2)
    attn = [n for n, m in model.named_modules() if n.endswith(".attn")]
    assert attn and all(plan[n] == ("heads",) for n in attn)
    layers = [n for n in plan if n.startswith("trans_")
              and n.endswith(tuple("0123456789"))]
    assert layers and all(plan[n] == ("ffn",) for n in layers)
    assert plan["bert.layers.0"] == ("heads", "ffn")
    assert not any("gmu" in n or "audio" in n for n in plan)


def test_spec_fitting_to_mesh():
    """hidden 300 over 12 heads (iemocap) on an 8-way tensor group: the
    attentions replicate, the FFNs (1200 wide) split; BERT-base's 12
    heads replicate and its 3072-wide FFN splits."""
    exp = get_preset("iemocap")
    model = get_model(exp.model, device="meta")
    plan = sharding.split_plan(model, 8)
    assert all(v == ("ffn",) for v in plan.values())
    assert "trans_l_with_a.layers.0" in plan and "bert.layers.0" in plan
    plan2 = sharding.split_plan(model, 2)
    assert plan2["trans_l_with_a.layers.0.attn"] == ("heads",)
    assert plan2["bert.layers.0"] == ("heads", "ffn")


def test_split_parts_put_the_weights_back_together():
    cfg = _tiny()
    whole = get_model(cfg, device="cpu", seed=1)
    parts = []
    for rank in range(2):
        model = get_model(cfg, device="cpu", seed=1)
        record = sharding.split_tensor(model, TensorSplit(None, rank, 2))
        parts.append((record, model.state_dict()))
    record = parts[0][0]
    assert "trans_l_with_a.layers.0.attn.q_proj.weight" in record
    assert record["trans_l_with_a.layers.0.attn.out_proj.weight"] == 1
    assert "trans_l_with_a.layers.0.attn.out_proj.bias" not in record
    assert record["bert.layers.0.attention.query.bias"] == 0
    for name, w in whole.state_dict().items():
        if name in record:
            got = torch.cat([p[1][name] for p in parts], record[name])
        else:
            got = parts[1][1][name]
        assert torch.equal(got, w), name
    m = get_model(cfg, device="cpu", seed=1)
    sharding.split_tensor(m, TensorSplit(None, 1, 2))
    assert m.trans_l_with_a.layers[0].attn.num_heads == 1
    assert m.trans_l_with_a.layers[0].attn.global_heads == 2


class _Mesh:
    """A (data, fsdp, tensor) mesh's shape and one rank's coordinates."""

    def __init__(self, shape, coords):
        self.shape = shape
        self._coords = dict(zip(("data", "fsdp", "tensor"), coords))

    def get_local_rank(self, name):
        return self._coords[name]


def test_place_batch_slices():
    batch = {"x": torch.arange(2 * 8 * 3).reshape(2, 8, 3),
             "y": torch.arange(2 * 8).reshape(2, 8)}
    seen = []
    for d in range(2):
        for f in range(2):
            for t in range(2):
                local, rows = sharding.place_batch(
                    batch, _Mesh((2, 2, 2), (d, f, t)))
                i = d * 2 + f
                assert rows == (2 * i, 8)
                assert torch.equal(local["x"], batch["x"][:, 2 * i:2 * i + 2])
                assert torch.equal(local["y"], batch["y"][:, 2 * i:2 * i + 2])
                seen.append(i)
    assert sorted(set(seen)) == [0, 1, 2, 3]
    flat, rows = sharding.place_batch({"x": torch.arange(8)},
                                      _Mesh((2, 1, 1), (1, 0, 0)),
                                      has_accum_axis=False)
    assert torch.equal(flat["x"], torch.arange(4, 8)) and rows == (4, 8)
    with pytest.raises(ValueError, match="do not split"):
        sharding.place_batch({"x": torch.zeros(2, 6)},
                             _Mesh((4, 1, 1), (0, 0, 0)))


def test_the_rules_raise_for_what_they_do_not_split():
    """Every model of the registry, and a grouped one, holds only module
    types the tensor split takes; a module type it does not know (here a
    made-up one) still raises, by type, not by the model's name."""
    from bpx_torch.models import MODELS
    tiny = _tiny().replace(num_vectors_a=8, num_vectors_v=8)
    for name in MODELS:
        cfg = tiny.replace(model=name)
        if name == "mmtrvat":
            cfg = cfg.replace(use_audio_encoder=False, num_vectors_l=8)
        assert sharding.unsplit_types(get_model(cfg, device="meta")) == [], \
            name
    grouped = get_model(tiny.replace(group_encoders=True), device="meta")
    assert sharding.unsplit_types(grouped) == []

    class MadeUp(torch.nn.Module):
        def forward(self, x):
            return x

    grouped.made_up = MadeUp()
    mesh = _Mesh((1, 1, 2), (0, 0, 0))
    mesh.get_group = lambda name: None
    with pytest.raises(NotImplementedError, match="MadeUp"):
        sharding.shard_model(grouped, mesh)


# ---------------------------------------------------------------------------
# block placement
# ---------------------------------------------------------------------------

B, H, TQ, TK = 4, 4, 6, 9
PIECES = {"data": (2, 4, 0, 0), "tensor": (4, 2, 0, 2),
          "data_tensor": (2, 2, 2, 2), "whole": (4, 4, 0, 0)}


@pytest.mark.parametrize("seeds", [7, [7, 11]], ids=["one_seed", "two_groups"])
@pytest.mark.parametrize("piece", list(PIECES))
def test_placed_flash_mask_is_the_global_slice(piece, seeds):
    """A (Bp, Hp) piece at (b_off, h_off) of a (B, H) call hashes as that
    slice of the call; with two seed groups, a piece of each group is
    placed within its group (the group's rows 0..)."""
    bp, hp, b_off, h_off = PIECES[piece]
    n = 1 if isinstance(seeds, int) else len(seeds)
    full = keep_mask(seeds, B * n, H, TQ, TK, 0.3)
    got = keep_mask(seeds, bp * n, hp, TQ, TK, 0.3, place=(b_off, h_off, H))
    want = torch.cat([full[g * B + b_off:g * B + b_off + bp,
                           h_off:h_off + hp] for g in range(n)])
    assert torch.equal(got, want)


def test_default_placement_is_todays_mask():
    for seeds in (3, [3, 9]):
        base = keep_mask(seeds, 4, 3, 5, 7, 0.2)
        assert torch.equal(keep_mask(seeds, 4, 3, 5, 7, 0.2,
                                     place=(0, 0, 3)), base)
    shape = (4, 5, 6)
    assert torch.equal(hash_keep(5, shape, 0.3, place=((0, 4), None, None)),
                       hash_keep(5, shape, 0.3))
    assert block_place(3) is None
    assert torch.equal(hash_keep(5, shape, 0.3, place=None),
                       hash_keep(5, shape, 0.3, place=(None,) * 3))


@pytest.mark.parametrize("piece", ["rows", "columns", "rows_columns",
                                   "heads"])
def test_placed_hash_mask_is_the_global_slice(piece):
    """Residual-stream blocks at their batch rows, a feature-split block at
    its columns (and rows), an einsum attention's probabilities at their
    heads: each the global mask's slice."""
    shape = (4, 5, 12)
    full = hash_keep(9, shape, 0.4)
    if piece == "rows":
        place, sl = block_place(3, (2, 4)), full[2:4]
    elif piece == "columns":
        place, sl = block_place(3, None, (-1, 6, 12)), full[..., 6:]
    elif piece == "rows_columns":
        place, sl = block_place(3, (2, 4), (2, 3, 12)), full[2:, :, 3:9]
    else:
        full = hash_keep(9, (4, 6, 3, 5), 0.4)
        place, sl = block_place(4, (1, 4), (1, 3, 6)), full[1:, 3:]
    got = hash_keep(9, sl.shape, 0.4, place=place)
    assert torch.equal(got, sl)


def test_placed_plain_flash_piece_is_the_global_slice():
    """The plain flash forward and backward with dropout on a (B/2, H/2)
    piece at its placement: the global call's slice of O, lse, dQ, dK and
    dV, within 1e-5 (fp32 products over another batch size; the masks
    themselves are compared bit for bit above, and the kernels' pieces on
    the card in chip_smoke.py's mesh phase)."""
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(4, 4, n, 8, generator=g) for n in
                   (6, 9, 9, 6))
    out, lse = flash_attention(q, k, v, True, None, 0.2, 5, return_lse=True)
    grads = flash_attention_backward(q, k, v, out, lse, do, True, None, 0.2,
                                     5)
    sl = (slice(2, 4), slice(0, 2))
    pq, pk, pv, pdo = (t[sl] for t in (q, k, v, do))
    pout, plse = flash_attention(pq, pk, pv, True, None, 0.2, 5,
                                 return_lse=True, place=(2, 0, 4))
    pgrads = flash_attention_backward(pq, pk, pv, pout, plse, pdo, True,
                                      None, 0.2, 5, place=(2, 0, 4))
    for got, want in zip((pout, plse, *pgrads), (out, lse, *grads)):
        torch.testing.assert_close(got, want[sl], rtol=1e-5, atol=1e-5)
    unplaced = flash_attention(pq, pk, pv, True, None, 0.2, 5)
    assert not torch.allclose(unplaced, out[sl])
    with pytest.raises(ValueError, match="does not hold"):
        flash_attention(pq, pk, pv, True, None, 0.2, 5, place=(0, 3, 4))


# a grouped pair's rank piece of a (2 x B_g, H) call: (rows, heads, b_off,
# h_off) of each member
PAIR_PIECES = {"data": (2, 4, 2, 0), "tensor": (4, 2, 0, 2),
               "data_tensor": (2, 2, 2, 2)}


def _pair_piece(t, b_off, rows, h_off, heads, global_rows=B):
    """Each member's rows b_off.. and heads h_off.. of a pair's folded
    (2 * global_rows, H, ...) tensor, members stacked again."""
    idx = torch.cat([torch.arange(m * global_rows + b_off,
                                  m * global_rows + b_off + rows)
                     for m in range(2)])
    return t[idx][:, h_off:h_off + heads].contiguous()


@pytest.mark.parametrize("piece", list(PAIR_PIECES))
def test_placed_pair_flash_piece_is_the_global_slice(piece):
    """A grouped pair folds its two members into one flash call over 2 x
    B_g rows.  A rank's piece (each member's rows b_off.. and heads
    h_off..), called as two seed groups of the one seed with the stride
    B_g x H_g between them, hashes each member's rows where the global
    call does: its mask bits, O, lse, dQ, dK and dV equal the global
    call's rows bit for bit; where the rank holds part of the rows, one
    group at the plain placement does not."""
    rows, heads, b_off, h_off = PAIR_PIECES[piece]
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2 * B, H, n, 8, generator=g) for n in
                   (TQ, TK, TK, TQ))
    out, lse = flash_attention(q, k, v, True, None, 0.3, 9, return_lse=True)
    grads = flash_attention_backward(q, k, v, out, lse, do, True, None, 0.3,
                                     9)
    sl = lambda t: _pair_piece(t, b_off, rows, h_off, heads)
    place = (b_off, h_off, H, B * H)
    pq, pk, pv, pdo = (sl(t) for t in (q, k, v, do))
    pout, plse = flash_attention(pq, pk, pv, True, None, 0.3, [9, 9],
                                 return_lse=True, place=place)
    pgrads = flash_attention_backward(pq, pk, pv, pout, plse, pdo, True,
                                      None, 0.3, [9, 9], place=place)
    for name, got, want in zip(("O", "lse", "dQ", "dK", "dV"),
                               (pout, plse, *pgrads), (out, lse, *grads)):
        assert torch.equal(got, sl(want)), name
    full = keep_mask(9, 2 * B, H, TQ, TK, 0.3)
    got = keep_mask([9, 9], 2 * rows, heads, TQ, TK, 0.3, place=place)
    assert torch.equal(got, sl(full))
    one_group = keep_mask(9, 2 * rows, heads, TQ, TK, 0.3,
                          place=place[:3])
    assert torch.equal(one_group, sl(full)) == (rows == B)


@pytest.mark.parametrize("piece", ["rows", "rows_columns", "heads"])
def test_placed_pair_hash_mask_is_the_global_slice(piece):
    """A pair's residual, ReLU and embedding dropouts on (2, B, T, E)
    stacks place dim 1 as the batch (``batch_dim``); its einsum
    attention's probabilities each member's rows and the rank's heads:
    each mask the global one's slice, bit for bit."""
    from bpx_torch.ops.attention import dot_product_attention
    from bpx_torch.ops.dropout import SeedStream, maybe_dropout
    if piece == "heads":
        g = torch.Generator().manual_seed(4)
        q, k, v = (torch.randn(2 * B, H, n, 8, generator=g) for n in
                   (TQ, TK, TK))
        seeds = lambda rows=None: SeedStream(21, rows)
        full = dot_product_attention(q, k, v, None, 0.4, True, seeds(),
                                     members=2)
        sl = lambda t: _pair_piece(t, 2, 2, 2, 2)
        got = dot_product_attention(sl(q), sl(k), sl(v), None, 0.4, True,
                                    seeds((2, B)), heads=(2, H), members=2)
        assert torch.equal(got, sl(full))
        return
    x = torch.rand(2, B, 5, 12, generator=torch.Generator().manual_seed(5))
    full = maybe_dropout(x, 0.4, True, SeedStream(8), batch_dim=1)
    if piece == "rows":
        split, sl = None, (slice(None), slice(2, 4))
    else:
        split, sl = (-1, 6, 12), (slice(None), slice(2, 4), slice(None),
                                  slice(6, 12))
    got = maybe_dropout(x[sl], 0.4, True, SeedStream(8, (2, B)), split,
                        batch_dim=1)
    assert torch.equal(got, full[sl])
    assert torch.equal(hash_keep(8, x[sl].shape, 0.4, place=block_place(
        4, (2, B), split, batch_dim=1)), hash_keep(8, x.shape, 0.4)[sl])


def test_parallel_package_is_covered_by_the_port_rules():
    from tests.test_torch_port_rules import _port_files
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {"bpx_torch/parallel/__init__.py", "bpx_torch/parallel/mesh.py",
            "bpx_torch/parallel/sharding.py",
            "bpx_torch/parallel/collectives.py"} <= files


def test_training_config_reads_the_mesh():
    from bpx_torch.cli import train as cli
    import argparse
    parser = argparse.ArgumentParser()
    cli.get_args(parser)
    exp = cli.args_to_config(parser.parse_args(
        ["--mesh_data", "2", "--mesh_fsdp", "2", "--mesh_tensor", "2"]))
    assert dataclasses.astuple(exp.train.mesh)[:3] == (2, 2, 2)
