"""Flash attention, forward and backward: the CUDA kernels
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` and their plain versions.

The counterpart is ``bpx/ops/pallas_attention.py::flash_attention`` with
``layout="bhtd"`` and its ``custom_vjp``: q is pre-scaled by
``head_dim**-0.5``; the offset band ``col <= row + |Tk - Tq|`` (from the
unpadded lengths, dropped when it is vacuous) and per-sample key lengths
``kv_lens`` mask scores with -1e30; the softmax statistics are fp32 and the
unnormalised probabilities are cast to the input dtype before the product
with V, divided by the row sum after.  Dropout on the probabilities uses the
TPU kernels' counter hash ``_keep_mask`` of (seed, batch*head, row, col),
so the backward regenerates the mask: the row sum keeps the undropped
probabilities, kept ones are scaled by ``float32(1 / (1 - rate))``.

The backward recomputes P from the saved log-sum-exp, with ``delta =
rowsum(dO * O)`` in fp32: on the card the backward's kernels compute it
(what the JAX package's kernels compute in-kernel with ``BPX_XLA_DELTA=0``;
its default computes it in XLA before them, the same function), on the CPU
:func:`attention_delta`'s plain version.  At head dims 64 and 96 a backward
is three kernels (delta, dK/dV, dQ); at the others two: the dQ kernel
computes delta for its rows and leaves it for the dK/dV kernel after it.
Masked entries get P = 0, so a row with no visible key
gets zero gradients although its forward attended uniformly: that is the
JAX package's backward, not the true derivative.

The kernels take head dims 25, 30, 50, 60, 64, 96, 128, 192 and 256.  A
narrow head (25, 30: the mmtrvat presets' 300-wide streams over 12 or 10
heads) runs the same kernels at 32 columns with the padding zeroed in
shared memory, and 50 and 60 (mmtrvpa's 600-wide memory encoders over 12
or 10 heads) run at 64 columns so (the head_dim-128 kernels, forward and
backward, at that width: ``runs_wide`` in ``csrc/flash_common.cuh``):
nothing is padded in device memory, and the strided (B, H, T, D) views of
a fused projection go to the kernels without a copy.  The forward at 64
and 96 is one kernel (``flash_fwd_kernel``); at 128, 50 and 60
``flash_fwd_wide_kernel`` takes the last query tile first and issues the
scores of a key tile beside P V of the tile before; at 25 and 30
``flash_fwd_narrow_kernel``.  At 128 (mmimdb: 768 over 6 heads) the dK/dV
kernel runs two warpgroups a block, each over half of every query tile and
all the columns (at 50 and 60 one warpgroup, three blocks an SM); at 192
and 256 (mmtrvpa's 2E-wide memory encoders at moviescope's and mmimdb's
widths: 1536 over 8 or 6 heads) the two warpgroups of the dQ kernel split
each key tile's keys, and those of the dK/dV kernel each query tile's
queries, so no product is computed twice; the forward at 192 and 256 runs
two warpgroups on 128 query rows (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``).

Seeds per group: the ops take a list of dropout seeds, one per group of
the batch (one element on the single-seed path).  With n seeds the B·H
blocks form n groups of B·H / n consecutive blocks, and block ``bh`` hashes
with ``seeds[bh // (B·H / n)]`` and its index in its group: each group's
mask is the one a call over that group alone with that seed gives.  Under
``torch.func.vmap`` (the multi-seed step, ``train/multiseed.py``) each op's
vmap rule folds the vmapped axis into the batch of one launch over S·B·H,
through views of the (S, B, H, T, D) tensors, with the S seeds (or the
one seed repeated) as the list; ``kv_lens`` is repeated for the S·B rows.
The kernels take at most ``MAX_SEED_GROUPS`` seeds: above that the vmap
rule launches one call per chunk of at most that many groups.

Block placement (the sharded step, ``bpx_torch/parallel``): a rank of a
mesh holds some batch rows and, under a tensor split, some heads of the
global attention, whose dropout hashes the global (batch * head) index as
the TPU kernels do under GSPMD.  ``place = (b_off, h_off, H_g)`` says
where a call's blocks sit: its batch row b and head h hash as global block
``(b_off + b) * H_g + h_off + h``, so each piece's mask is the slice of the
global call's.  With seed groups, a block's index in its group is what is
placed.  None is ``(0, 0, H)``: every block its own index, as before.  A
fourth entry, ``stride``, moves group g's blocks on by g * stride global
blocks (0 by default: each group placed from its own block 0).  A
grouped pair (``ops/encoder.py``) folds its two members into the batch of
one call: placed, it runs as two groups of B·H blocks sharing one seed,
with ``stride = B_g * H_g``, so that member m's row b hashes as global row
``m * B_g + b_off + b``, as the one-process call hashes its 2·B_g rows.  A
placed call with dropout launches the kernels' build for seed groups (one
group, or a pair's two, its blocks placed); the one-group build, which
every unplaced call takes, is the code it was before placement.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Union

import torch

from bpx_torch.ops import _cuda
from bpx_torch.ops.dispatch import check_device, use_kernel
from bpx_torch.ops.dropout import keep_threshold, mul32, seed_list
from bpx_torch.ops.masks import band_allowed

MASK_FILL = -1e30
#: head dims the kernels are instantiated for (``with_head_dim`` in
#: ``csrc/flash_common.cuh``), each with the alignment (in elements) its rows
#: need: 16-byte chunks at 64, 96, 128, 192 and 256, 8-byte cp.async words
#: at 60 (a head of a fused projection starts every 120 bytes), 4-byte ones
#: at 30 and 50 (every 60 and 100 bytes), and at 25 (the mmtrvat presets'
#: 300 / 12 heads, whose rows start at any even byte of a fused projection)
#: plain 2-byte loads
KERNEL_ALIGN = {25: 1, 30: 2, 50: 2, 60: 4, 64: 8, 96: 8, 128: 8, 192: 8,
                256: 8}
KERNEL_HEAD_DIMS = tuple(KERNEL_ALIGN)
#: the TPU kernels' single-pass key range and key block (``tk_p`` below)
SINGLE_PASS_MAX_K = 1024
BLOCK_K = 128
#: seeds one launch takes (``kMaxSeedGroups`` in ``csrc/flash_common.cuh``),
#: passed by value in the kernels' parameters
MAX_SEED_GROUPS = 16


def effective_band(tq: int, tk: int, masked: bool):
    """(masked, offset) after dropping a vacuous band: with
    ``offset >= Tk - 1`` every key is visible to every query row."""
    offset = abs(tk - tq)
    return masked and offset < tk - 1, offset


def padded_tk(tk: int) -> int:
    """The key length the TPU kernels index their dropout hash with: Tk,
    or Tk rounded up to 128 for a long Tk that is not a multiple of 128."""
    if tk <= SINGLE_PASS_MAX_K or tk % BLOCK_K == 0:
        return tk
    return (tk + BLOCK_K - 1) // BLOCK_K * BLOCK_K


def inv_keep(rate: float) -> float:
    """float32(1 / (1 - rate)), as a Python float."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).item()


def check_place(place, H: int):
    """``place`` as a (b_off, h_off, H_g, stride) tuple of ints (a
    3-tuple's stride 0), checked against the call's H local heads; None
    stays None."""
    if place is None:
        return None
    if len(place) not in (3, 4):
        raise ValueError(f"place must be (b_off, h_off, H_g[, stride]), "
                         f"got {place}")
    b_off, h_off, heads, stride = (*(int(x) for x in place), 0)[:4]
    if b_off < 0 or h_off < 0 or h_off + H > heads or stride < 0:
        raise ValueError(f"place {tuple(place)} does not hold {H} heads")
    return b_off, h_off, heads, stride


def placed_blocks(n: int, H: int, place=None,
                  device=None) -> torch.Tensor:
    """The hash index of local blocks 0..n-1 of a group (n = rows * H):
    the global block ``(b_off + bh // H) * H_g + h_off + bh % H`` under
    ``place``, else ``bh`` (int64)."""
    bh = torch.arange(n, dtype=torch.int64, device=device)
    if place is None:
        return bh
    b_off, h_off, heads, _ = check_place(place, H)
    return (b_off + bh // H) * heads + h_off + bh % H


def keep_mask(seed, B: int, H: int, Tq: int, Tk: int, rate: float,
              device=None, place=None) -> torch.Tensor:
    """(B, H, Tq, Tk) bool: the TPU kernels' ``_keep_mask`` at every (batch
    * head, row, col), bit-identical, computed in int64 cut to 32 bits.
    ``seed`` is a uint32, or a list of n, one per group of B / n batch
    rows, each group hashed with its seed and its own (batch * head)
    index from 0; ``place`` (b_off, h_off, H_g[, stride]) places each
    block (each group's, group g's ``g * stride`` blocks on) in the global
    call."""
    m = 0xFFFFFFFF
    seeds = seed_list(seed)
    if B % len(seeds):
        raise ValueError(f"{len(seeds)} seed groups do not divide a batch "
                         f"of {B}")
    bh = placed_blocks(B // len(seeds) * H, H, place, device)
    stride = 0 if place is None else check_place(place, H)[3]
    row = torch.arange(Tq, dtype=torch.int64, device=device)
    col = torch.arange(Tk, dtype=torch.int64, device=device)
    keep = []
    for g, s in enumerate(seeds):
        idx = (mul32(bh + g * stride, 0x85EBCA6B)[:, None, None]
               + mul32(row, padded_tk(Tk))[None, :, None]
               + col[None, None, :]) & m
        x = (mul32(idx, 0x9E3779B9) + (s & m)) & m
        x = x ^ (x >> 16)
        x = mul32(x, 0x85EBCA6B)
        x = x ^ (x >> 13)
        keep.append(x >= keep_threshold(rate))
    return torch.cat(keep).reshape(B, H, Tq, Tk)


def _visible(B, Tq, Tk, masked, kv_lens, device):
    """(B, 1, Tq, Tk) or (Tq, Tk) bool of the visible keys, or None."""
    masked, _ = effective_band(Tq, Tk, masked)
    ok = None
    if kv_lens is not None:
        col = torch.arange(Tk, device=device)
        ok = (col[None, :] < kv_lens.to(device)[:, None])[:, None, None, :]
    if masked:
        band = band_allowed(Tq, Tk, device)
        ok = band if ok is None else ok & band
    return ok


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, masked: bool = True,
                              kv_lens: Optional[torch.Tensor] = None,
                              dropout_rate: float = 0.0,
                              dropout_seed: Optional[int] = None,
                              place=None):
    """Plain forward on (B, H, T, D) tensors: returns (out, lse), out in
    q's dtype and layout (B, H, Tq, D), lse fp32 (B, H, Tq)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    ok = _visible(B, Tq, Tk, masked, kv_lens, q.device)
    if ok is not None:
        s = s.masked_fill(~ok, MASK_FILL)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if dropout_rate > 0.0:
        keep = keep_mask(dropout_seed, B, H, Tq, Tk, dropout_rate, q.device,
                         place)
        p = torch.where(keep, p * inv_keep(dropout_rate), 0.0)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe).to(q.dtype)
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out, lse


def flash_attention_backward_reference(q, k, v, dout, lse, delta,
                                       masked: bool = True,
                                       kv_lens: Optional[torch.Tensor] = None,
                                       dropout_rate: float = 0.0,
                                       dropout_seed: Optional[int] = None,
                                       place=None):
    """Plain backward: (dq, dk, dv) in q's dtype from the saved lse (B, H,
    Tq) and ``delta = rowsum(dO * O)`` (B, H, Tq), both fp32."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    qf, kf = q.float(), k.float()
    s = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.exp(s - lse[..., None])
    ok = _visible(B, Tq, Tk, masked, kv_lens, q.device)
    if ok is not None:
        p = torch.where(ok, p, 0.0)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    pd = p
    if dropout_rate > 0.0:
        keep = keep_mask(dropout_seed, B, H, Tq, Tk, dropout_rate, q.device,
                         place)
        scale = inv_keep(dropout_rate)
        pd = torch.where(keep, p * scale, 0.0)
        dp = torch.where(keep, dp * scale, 0.0)
    dv = torch.matmul(pd.to(dout.dtype).float().transpose(-1, -2),
                      dout.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dq = torch.matmul(ds, kf)
    dt = q.dtype
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check(q, k, v, kv_lens, dropout_rate, dropout_seed):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, T, D)")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kv_lens is not None and kv_lens.shape != (B,):
        raise ValueError(f"kv_lens must be ({B},), got {tuple(kv_lens.shape)}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs a uint32 dropout_seed")
    # a list's length is checked where it is used: against the groups of
    # the batch by the kernels and the plain version, against the vmapped
    # axis by the vmap rules
    return seed_list(dropout_seed)


def _kernel_layout(B, T, H, D, like):
    """An empty (B, H, T, D) view of (B, T, H, D) memory: the layout the
    kernels write O, dQ, dK and dV in, and so the layout of the ops'
    outputs on every device."""
    return torch.empty(B, T, H, D, dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _forward(q, k, v, masked, kv_lens, rate, seeds, place=None):
    if use_kernel(q):
        return _launch(q, k, v, masked, kv_lens, rate, seeds, place)
    out, lse = flash_attention_reference(q, k, v, masked, kv_lens, rate,
                                         seeds, place)
    B, H, Tq, D = q.shape
    return _kernel_layout(B, Tq, H, D, out).copy_(out), lse


def _backward(q, k, v, out, lse, dout, masked, kv_lens, rate, seeds,
              place=None):
    if use_kernel(q):
        return _launch_bwd(q, k, v, dout, lse, out, masked, kv_lens, rate,
                           seeds, place)
    grads = flash_attention_backward_reference(
        q, k, v, dout, lse, attention_delta_reference(dout, out), masked,
        kv_lens, rate, seeds, place)
    B, H = q.shape[:2]
    return tuple(_kernel_layout(B, g.shape[2], H, g.shape[3], g).copy_(g)
                 for g in grads)


# The kernels as custom operators (namespace ``bpx_torch``): one node each
# under ``torch.export`` and a name that a selective-checkpoint policy can
# match.  One impl serves the CPU and CUDA keys: the kernel for CUDA
# tensors, the plain version for CPU ones (``use_kernel``), both in the
# layout the fake impl states.  The impls call ``_forward`` / ``_backward``
# by name at each call.

torch.library.define(
    "bpx_torch::flash_fwd",
    "(Tensor q, Tensor k, Tensor v, Tensor? kv_lens, bool masked, "
    "float rate, int[]? seeds, int[]? place=None) -> (Tensor, Tensor)")
torch.library.define(
    "bpx_torch::flash_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor dout, "
    "Tensor? kv_lens, bool masked, float rate, int[]? seeds, "
    "int[]? place=None) -> (Tensor, Tensor, Tensor)")
torch.library.define("bpx_torch::flash_delta",
                     "(Tensor dout, Tensor out) -> Tensor")
_FLASH_FWD = torch.ops.bpx_torch.flash_fwd.default
_FLASH_BWD = torch.ops.bpx_torch.flash_bwd.default
_FLASH_DELTA = torch.ops.bpx_torch.flash_delta.default


@torch.library.impl("bpx_torch::flash_fwd", ("cpu", "cuda"))
def _(q, k, v, kv_lens, masked, rate, seeds, place=None):
    return _forward(q, k, v, masked, kv_lens, rate, seeds, place)


@torch.library.register_fake("bpx_torch::flash_fwd")
def _(q, k, v, kv_lens, masked, rate, seeds, place=None):
    B, H, Tq, D = q.shape
    return (_kernel_layout(B, Tq, H, D, q),
            q.new_empty(B, H, Tq, dtype=torch.float32))


@torch.library.impl("bpx_torch::flash_bwd", ("cpu", "cuda"))
def _(q, k, v, out, lse, dout, kv_lens, masked, rate, seeds, place=None):
    return _backward(q, k, v, out, lse, dout, masked, kv_lens, rate, seeds,
                     place)


@torch.library.register_fake("bpx_torch::flash_bwd")
def _(q, k, v, out, lse, dout, kv_lens, masked, rate, seeds, place=None):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    return tuple(_kernel_layout(B, T, H, D, q) for T in (Tq, Tk, Tk))


def _setup_flash_fwd(ctx, inputs, output):
    q, k, v, kv_lens, masked, rate, seeds, place = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, kv_lens)
    ctx.config = (masked, rate, seeds, place)
    ctx.mark_non_differentiable(lse)


def _flash_fwd_grad(ctx, dout, _dlse):
    q, k, v, out, lse, kv_lens = ctx.saved_tensors
    masked, rate, seeds, place = ctx.config
    dq, dk, dv = _FLASH_BWD(q, k, v, out, lse, dout, kv_lens, masked, rate,
                            seeds, place)
    return dq, dk, dv, None, None, None, None, None


torch.library.register_autograd("bpx_torch::flash_fwd", _flash_fwd_grad,
                                setup_context=_setup_flash_fwd)


@torch.library.impl("bpx_torch::flash_delta", ("cpu", "cuda"))
def _(dout, out):
    if not use_kernel(dout):
        return attention_delta_reference(dout, out)
    return _launch_delta(dout, out)


@torch.library.register_fake("bpx_torch::flash_delta")
def _(dout, out):
    return out.new_empty(out.shape[:3], dtype=torch.float32)


# The vmap rule: the vmapped axis (the multi-seed step's seeds) folded into
# the batch of one call (with dropout over more than MAX_SEED_GROUPS seeds,
# one call per chunk of them), through views; outputs unfolded, again as
# views.  Autograd records the folded call, so its backward (flash_bwd, whose
# delta is flash_delta's) runs once over the folded tensors and needs no
# rule of its own.  torch.func.grad, under which vmap would reach the
# backward ops, cannot take these ops (ROADMAP.md).

def _fold(t, dim, n):
    """``t`` batched at ``dim`` (None: shared, expanded) as (n * B, ...): a
    view where the strides allow one, else a copy, counted in
    ``flash_attention.fold_copies``."""
    t = t.movedim(dim, 0) if dim is not None else t.expand(n, *t.shape)
    shape = (n * t.shape[1], *t.shape[2:])
    try:
        return t.view(shape)
    except RuntimeError:
        flash_attention.fold_copies += 1
        return t.reshape(shape)


def _fold_kv_lens(kv_lens, dim, n):
    """Per-sample key lengths for the n * B folded rows: a shared (B,)
    ``kv_lens`` repeated n times."""
    if kv_lens is None:
        return None
    if dim is None:
        return kv_lens.repeat(n)
    return kv_lens.movedim(dim, 0).reshape(-1)


def _fold_seeds(seeds, n):
    """One seed per folded group: the vmapped axis's n seeds, or one seed
    shared by every slice repeated n times."""
    if seeds is None:
        return None
    if len(seeds) not in (1, n):
        raise ValueError(f"{len(seeds)} dropout seeds for a vmapped axis of "
                         f"{n}: give one, or one per slice")
    return list(seeds) * (n // len(seeds))


def _unfold(t, n):
    return t.unflatten(0, (n, -1))


@torch.library.register_vmap("bpx_torch::flash_fwd")
def _(info, in_dims, q, k, v, kv_lens, masked, rate, seeds, place=None):
    n = info.batch_size
    qf, kf, vf = (_fold(t, d, n) for t, d in zip((q, k, v), in_dims))
    lens = _fold_kv_lens(kv_lens, in_dims[3], n)
    groups = _fold_seeds(seeds, n)
    if rate > 0.0 and len(groups) > MAX_SEED_GROUPS:
        out, lse = _chunked(qf, kf, vf, lens, masked, rate, groups, place)
    else:
        out, lse = _FLASH_FWD(qf, kf, vf, lens, masked, rate, groups, place)
    return (_unfold(out, n), _unfold(lse, n)), (0, 0)


def _chunked(q, k, v, kv_lens, masked, rate, groups, place):
    """The folded call over more seed groups than the kernels take, as
    one call per chunk of at most ``MAX_SEED_GROUPS`` groups: a group's
    mask depends on its seed and its blocks' index in the group only, so
    each chunk draws what the whole call would.  Autograd records each
    chunk's call, so each chunk's backward is its own call too.  The
    outputs are joined in the kernels' (B, T, H, D) memory."""
    rows = q.shape[0] // len(groups)
    outs, lses = [], []
    for g in range(0, len(groups), MAX_SEED_GROUPS):
        part = slice(g * rows, (g + MAX_SEED_GROUPS) * rows)
        out, lse = _FLASH_FWD(
            q[part], k[part], v[part],
            None if kv_lens is None else kv_lens[part], masked, rate,
            groups[g:g + MAX_SEED_GROUPS], place)
        outs.append(out.transpose(1, 2))
        lses.append(lse)
    return torch.cat(outs).transpose(1, 2), torch.cat(lses)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    masked: bool = True,
                    kv_lens: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0,
                    dropout_seed: Union[int, Sequence[int], None] = None,
                    return_lse: bool = False, place=None):
    """(B, H, Tq, D) x (B, H, Tk, D) -> (B, H, Tq, D); q pre-scaled.

    The op ``bpx_torch::flash_fwd``: the kernels for CUDA tensors, the
    plain versions for CPU tensors, in the forward and (through autograd,
    ``bpx_torch::flash_bwd``) in the backward.  Autograd records the op only
    when grad is enabled and q, k or v requires it; otherwise nothing is
    saved.  The kernels take bf16 with a head_dim of ``KERNEL_HEAD_DIMS``
    and any strides whose last dim is contiguous; the output is a (B, H, Tq, D)
    view of (B, Tq, H, D) memory, so ``out.transpose(1, 2).reshape(B, Tq,
    H * D)`` is free.  ``dropout_rate > 0`` needs ``dropout_seed``, a uint32
    Python int, or a list of n, one per group of B / n batch rows (under
    ``torch.func.vmap``: one per slice of the vmapped axis).  ``place``
    (b_off, h_off, H_g[, stride]) places the call's blocks in a global call
    for the dropout hash (the module docstring); None: unplaced.
    """
    check_device(q)
    seeds = _check(q, k, v, kv_lens, dropout_rate, dropout_seed)
    place = check_place(place, q.shape[1])
    out, lse = _FLASH_FWD(q, k, v, kv_lens, masked, float(dropout_rate),
                          seeds, None if place is None else list(place))
    return (out, lse) if return_lse else out


def flash_attention_backward(q, k, v, out, lse, dout, masked=True,
                             kv_lens=None, dropout_rate=0.0,
                             dropout_seed=None, place=None):
    """(dq, dk, dv) of :func:`flash_attention` for the output gradient
    ``dout`` (the op ``bpx_torch::flash_bwd``); the kernels (dQ with
    delta, then dK/dV; at head_dim 64 and 96 delta, dK/dV, dQ) for CUDA
    tensors, the plain version for CPU."""
    place = check_place(place, q.shape[1])
    return _FLASH_BWD(q, k, v, out, lse, dout, kv_lens, masked,
                      float(dropout_rate), seed_list(dropout_seed),
                      None if place is None else list(place))


def attention_delta_reference(dout: torch.Tensor,
                              out: torch.Tensor) -> torch.Tensor:
    """Plain ``rowsum(dO * O)`` in fp32: (B, H, T, D) -> (B, H, T)."""
    return (dout.float() * out.float()).sum(-1)


def attention_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` in fp32 of (B, H, T, D) tensors (the op
    ``bpx_torch::flash_delta``): the head_dim 64/96 backward's first kernel
    on its own (at every head dim) for CUDA tensors, the plain version for
    CPU."""
    return _FLASH_DELTA(dout, out)


def _launch_delta(dout, out):
    B, H, T, D = out.shape
    if dout.shape != out.shape:
        raise ValueError(f"dO {tuple(dout.shape)} and O {tuple(out.shape)}")
    _check_head_dim(D)
    dout, out = (_kernel_ready(n, t, dout.device)
                 for n, t in (("dO", dout), ("O", out)))
    delta = torch.empty(B, H, T, dtype=torch.float32, device=out.device)
    if delta.numel() == 0:
        return delta
    err = _cuda.library().bpx_flash_delta(
        out.data_ptr(), dout.data_ptr(), delta.data_ptr(), B, H, T, D,
        *out.stride()[:3], *dout.stride()[:3],
        torch.cuda.current_stream(out.device).cuda_stream)
    _cuda.check(err, "flash_delta")
    attention_delta.launches += 1
    return delta


def blocks_per_sm(head_dim: int) -> dict:
    """Blocks of the forward, dK/dV and dQ kernels at ``head_dim`` that
    one SM of the current card holds (CUDA's occupancy calculator)."""
    _check_head_dim(head_dim)
    lib = _cuda.library()
    got = {}
    for name, call in (
            ("forward", lambda n: lib.bpx_flash_fwd_blocks_per_sm(
                head_dim, n)),
            ("dK/dV", lambda n: lib.bpx_flash_bwd_blocks_per_sm(
                head_dim, 0, n)),
            ("dQ", lambda n: lib.bpx_flash_bwd_blocks_per_sm(
                head_dim, 1, n))):
        n = ctypes.c_int(0)
        _cuda.check(call(ctypes.byref(n)), f"{name} occupancy")
        got[name] = n.value
    return got


def _check_head_dim(D):
    if D not in KERNEL_ALIGN:
        raise NotImplementedError(
            f"flash kernel is built for head_dim {KERNEL_HEAD_DIMS}, got {D}")


def _kernel_ready(name, t, device):
    """``t`` as the kernels take it: on ``device``, bf16, the last dim
    contiguous, and strides and data pointer multiples of the head dim's
    alignment (``KERNEL_ALIGN``); a copy only where they are not.  A
    narrow head's strided views (D = 25 at any stride, D = 30 and 50 at
    even ones, D = 60 at multiples of 4) go to the kernel as they are."""
    if t.device != device:
        raise RuntimeError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash kernel takes bfloat16, {name} is {t.dtype}")
    align = KERNEL_ALIGN[t.shape[3]]
    if (t.stride(3) != 1 or any(s % align for s in t.stride()[:3])
            or t.data_ptr() % (2 * align)):
        # a fresh buffer: contiguous() would return a misaligned but
        # contiguous view unchanged
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _kv_lens_ptr(kv_lens, device):
    if kv_lens is None:
        return None, None
    if kv_lens.device != device or kv_lens.dtype != torch.int32:
        raise TypeError("kv_lens must be int32 on q's device")
    kv_lens = kv_lens.contiguous()
    return kv_lens, kv_lens.data_ptr()


def _dropout_args(rate, seed, tk, batch, heads=1, place=None):
    """The kernels' dropout arguments: on, the seeds (a C array, one per
    group of ``batch`` / n rows), n, threshold, inv_keep, tk_p, and the
    placement b_off, h_off, H_g, stride (0, 0, ``heads``, 0 unplaced)."""
    placed = check_place(place, heads) or (0, 0, heads, 0)
    if rate <= 0.0:
        return (0, None, 1, 0, 1.0, tk, *placed)
    seeds = seed_list(seed)
    n = len(seeds)
    if n > MAX_SEED_GROUPS or batch % n:
        raise ValueError(f"the flash kernels take 1 to {MAX_SEED_GROUPS} "
                         f"seed groups that divide the batch of {batch}, "
                         f"got {n}")
    return (1, (ctypes.c_uint * n)(*seeds), n, keep_threshold(rate),
            inv_keep(rate), padded_tk(tk), *placed)


def _launch(q, k, v, masked, kv_lens, rate=0.0, seeds=None, place=None):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    _check_head_dim(D)
    q, k, v = (_kernel_ready(n, t, q.device)
               for n, t in (("q", q), ("k", k), ("v", v)))
    masked, offset = effective_band(Tq, Tk, masked)
    kv_lens, kvl_ptr = _kv_lens_ptr(kv_lens, q.device)
    out = _kernel_layout(B, Tq, H, D, q)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    err = _cuda.library().bpx_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), kvl_ptr, B, H, Tq, Tk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(masked), offset, *_dropout_args(rate, seeds, Tk, B, H, place),
        torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "flash_fwd")
    flash_attention.launches += 1
    flash_attention.dropout_launches += int(rate > 0.0)
    return out, lse


def _launch_bwd(q, k, v, dout, lse, out, masked, kv_lens, rate=0.0,
                seeds=None, place=None):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    _check_head_dim(D)
    q, k, v, dout, out = (_kernel_ready(n, t, q.device) for n, t in
                          (("q", q), ("k", k), ("v", v), ("dO", dout),
                           ("O", out)))
    masked, offset = effective_band(Tq, Tk, masked)
    kv_lens, kvl_ptr = _kv_lens_ptr(kv_lens, q.device)
    lse = lse.float().contiguous()
    delta = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    grads = [_kernel_layout(B, T, H, D, q) for T in (Tq, Tk, Tk)]
    dq, dk, dv = grads
    if q.numel() == 0 or k.numel() == 0:
        return tuple(g.zero_() for g in grads)
    strides = [s for t in (q, k, v, dout, out, dq, dk, dv)
               for s in t.stride()[:3]]
    err = _cuda.library().bpx_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        out.data_ptr(), lse.data_ptr(), delta.data_ptr(), kvl_ptr,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Tq, Tk, D,
        *strides, int(masked), offset,
        *_dropout_args(rate, seeds, Tk, B, H, place),
        torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "flash_bwd")
    flash_attention_backward.launches += 1
    return dq, dk, dv


#: forward kernel launches (and those with dropout) since last set to 0
flash_attention.launches = 0
flash_attention.dropout_launches = 0
#: backward calls that launched their kernels (dQ with delta and dK/dV; or,
#: at head_dim 64 and 96, delta, dK/dV, dQ)
flash_attention_backward.launches = 0
#: launches of the delta kernel on its own (not those inside the backward)
attention_delta.launches = 0
#: tensors a vmap rule copied to fold the vmapped axis into the batch
flash_attention.fold_copies = 0
