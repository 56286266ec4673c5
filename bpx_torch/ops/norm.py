"""LayerNorm, forward and backward: the CUDA kernels ``csrc/layer_norm.cu``
and ``csrc/layer_norm_bwd.cu`` and their plain versions.

The counterpart is ``bpx/ops/norm.py`` and its ``custom_vjp``: fp32
statistics over the whole last axis (two-pass variance), fp32 weight and
bias, output cast to the module's compute dtype.  The forward kernel
replaces ``_ln_fwd_kernel`` and saves (mu, rstd); the backward kernel
replaces ``_ln_bwd_kernel``: dx in x's dtype from the saved statistics,
fp32 weight and bias gradients.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from bpx_torch.ops import _cuda
from bpx_torch.ops.dispatch import check_device, use_kernel

_DTYPES = (torch.bfloat16, torch.float32)


def layer_norm_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         eps: float, out_dtype: Optional[torch.dtype] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: (y, mu, rstd) with mu and rstd of shape x.shape[:-1]."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * w.float() + b.float()
    return y.to(out_dtype), mu.squeeze(-1), rstd.squeeze(-1)


def layer_norm_backward_reference(x, w, mu, rstd, dy):
    """Plain backward: (dx in x's dtype, dw, db fp32) from the forward's
    fp32 (mu, rstd) of shape x.shape[:-1]."""
    e = x.shape[-1]
    xf = x.reshape(-1, e).float()
    g = dy.reshape(-1, e).float()
    xhat = (xf - mu.reshape(-1, 1)) * rstd.reshape(-1, 1)
    a = g * w.float()
    m1 = a.sum(-1, keepdim=True) / e
    m2 = (a * xhat).sum(-1, keepdim=True) / e
    dx = rstd.reshape(-1, 1) * (a - m1 - xhat * m2)
    return (dx.to(x.dtype).reshape(x.shape), (g * xhat).sum(0), g.sum(0))


def _forward(x, w, b, eps, out_dtype):
    if use_kernel(x):
        return _launch(x, w, b, eps, out_dtype)
    y, mu, rstd = layer_norm_reference(x, w, b, eps, out_dtype)
    return y.contiguous(), mu, rstd


def _backward(x, w, mu, rstd, dy):
    if use_kernel(x):
        return _launch_bwd(x, w, mu, rstd, dy)
    return layer_norm_backward_reference(x, w, mu, rstd, dy)


# The kernels as custom operators (namespace ``bpx_torch``), one node each
# under ``torch.export``; one impl serves the CPU and CUDA keys: the kernel
# for CUDA tensors, the plain version for CPU ones, both contiguous, as the
# fake states.  The impls call ``_forward`` / ``_backward`` by name.

torch.library.define(
    "bpx_torch::layer_norm",
    "(Tensor x, Tensor w, Tensor b, float eps, ScalarType out_dtype) "
    "-> (Tensor, Tensor, Tensor)")
torch.library.define(
    "bpx_torch::layer_norm_bwd",
    "(Tensor x, Tensor w, Tensor mu, Tensor rstd, Tensor dy) "
    "-> (Tensor, Tensor, Tensor)")
_LAYER_NORM = torch.ops.bpx_torch.layer_norm.default
_LAYER_NORM_BWD = torch.ops.bpx_torch.layer_norm_bwd.default


@torch.library.impl("bpx_torch::layer_norm", ("cpu", "cuda"))
def _(x, w, b, eps, out_dtype):
    return _forward(x, w, b, eps, out_dtype)


@torch.library.register_fake("bpx_torch::layer_norm")
def _(x, w, b, eps, out_dtype):
    mu = x.new_empty(x.shape[:-1], dtype=torch.float32)
    return x.new_empty(x.shape, dtype=out_dtype), mu, torch.empty_like(mu)


@torch.library.impl("bpx_torch::layer_norm_bwd", ("cpu", "cuda"))
def _(x, w, mu, rstd, dy):
    return _backward(x, w, mu, rstd, dy)


@torch.library.register_fake("bpx_torch::layer_norm_bwd")
def _(x, w, mu, rstd, dy):
    dw = w.new_empty(x.shape[-1:], dtype=torch.float32)
    return x.new_empty(x.shape), dw, torch.empty_like(dw)


def _setup_layer_norm(ctx, inputs, output):
    x, w, _, _, _ = inputs
    _, mu, rstd = output
    ctx.save_for_backward(x, w, mu, rstd)
    ctx.mark_non_differentiable(mu, rstd)


def _layer_norm_grad(ctx, dy, _dmu, _drstd):
    x, w, mu, rstd = ctx.saved_tensors
    dx, dw, db = _LAYER_NORM_BWD(x, w, mu, rstd, dy)
    return dx, dw, db, None, None


torch.library.register_autograd("bpx_torch::layer_norm", _layer_norm_grad,
                                setup_context=_setup_layer_norm)


# The vmap rule (the multi-seed step: x, weight and bias per seed): one
# call of the op per slice of the vmapped axis, so S launches of the
# existing kernel, the outputs stacked.  Simple and right; the other
# route, one grouped launch with the weight row at ``row / rows_per_seed``
# and per-seed dw/db, needs a backward grid in which no block's rows
# straddle two seeds (its partial rows are summed per column over the
# whole grid), which the cooperative kernel's card-sized grid does not
# give.  Each slice's call is the op itself, so autograd records it and
# its backward is the kernel's, one launch a slice, with no rule of its
# own; the counters count every launch.

def _slices(t, dim, n):
    """The n slices of ``t`` along its vmapped ``dim`` (the same tensor n
    times where it is shared), each contiguous as the kernels take it."""
    if dim is None:
        return [t] * n
    return [s.contiguous() for s in t.movedim(dim, 0).unbind(0)]


@torch.library.register_vmap("bpx_torch::layer_norm")
def _(info, in_dims, x, w, b, eps, out_dtype):
    n = info.batch_size
    sliced = [_slices(t, d, n) for t, d in zip((x, w, b), in_dims)]
    outs = [_LAYER_NORM(xs, ws, bs, eps, out_dtype)
            for xs, ws, bs in zip(*sliced)]
    return tuple(torch.stack(o) for o in zip(*outs)), (0, 0, 0)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float, out_dtype: Optional[torch.dtype] = None,
               return_stats: bool = False):
    """LayerNorm over the last axis (the op ``bpx_torch::layer_norm``); the
    kernels for a CUDA tensor, the plain versions for a CPU tensor, in the
    forward and (through autograd, ``bpx_torch::layer_norm_bwd``) in the
    backward.  Autograd records the op only when grad is enabled and x, w
    or b requires it.  ``return_stats`` adds the fp32 (mu, rstd)."""
    check_device(x)
    out_dtype = out_dtype or x.dtype
    e = x.shape[-1]
    if w.shape != (e,) or b.shape != (e,):
        raise ValueError(f"weight/bias must be ({e},), got "
                         f"{tuple(w.shape)} / {tuple(b.shape)}")
    y, mu, rstd = _LAYER_NORM(x, w, b, float(eps), out_dtype)
    return (y, mu, rstd) if return_stats else y


def layer_norm_backward(x, w, mu, rstd, dy):
    """(dx, dw, db) of :func:`layer_norm` for the output gradient ``dy``
    (the op ``bpx_torch::layer_norm_bwd``); the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    return _LAYER_NORM_BWD(x, w, mu, rstd, dy)


def _launch(x, w, b, eps, out_dtype):
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"layer_norm kernel takes bf16/fp32, got "
                        f"{x.dtype} -> {out_dtype}")
    if w.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("layer_norm kernel takes fp32 weight and bias")
    if not (w.is_cuda and b.is_cuda and w.device == x.device == b.device):
        raise RuntimeError("x, weight and bias must be on one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise RuntimeError("layer_norm kernel takes contiguous tensors")
    e = x.shape[-1]
    n = x.numel() // e
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    mu = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    if n == 0:
        return y, mu, rstd
    vector_ok = all(t.data_ptr() % 16 == 0 for t in (x, w, b, y))
    err = _cuda.library().bpx_layer_norm_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), n, e, float(eps),
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        int(vector_ok), torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(err, "layer_norm")
    layer_norm.launches += 1
    return y, mu, rstd


def _launch_bwd(x, w, mu, rstd, dy):
    if x.dtype not in _DTYPES or dy.dtype not in _DTYPES:
        raise TypeError(f"layer_norm backward kernel takes bf16/fp32, got "
                        f"x {x.dtype}, dy {dy.dtype}")
    if w.dtype != torch.float32:
        raise TypeError("layer_norm backward kernel takes an fp32 weight")
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} vs x {tuple(x.shape)}")
    if not all(t.device == x.device for t in (w, mu, rstd, dy)):
        raise RuntimeError("layer_norm backward: tensors on several devices")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise RuntimeError("layer_norm kernel takes contiguous tensors")
    dy, mu, rstd = dy.contiguous(), mu.contiguous(), rstd.contiguous()
    e = x.shape[-1]
    n = x.numel() // e
    dx = torch.empty_like(x)
    if n == 0:
        dw = torch.zeros(e, dtype=torch.float32, device=x.device)
        return dx, dw, torch.zeros_like(dw)
    # the kernel writes every entry of dw and db: no memset
    dw = torch.empty(e, dtype=torch.float32, device=x.device)
    db = torch.empty_like(dw)
    lib = _cuda.library()
    vector_ok = all(t.data_ptr() % 16 == 0 for t in (x, dy, w, dx))
    flags = (int(x.dtype == torch.bfloat16), int(dy.dtype == torch.bfloat16),
             int(vector_ok))
    key = (x.device, n, e, flags)
    need = _WORKSPACE_NUMEL.get(key)
    if need is None:
        need = lib.bpx_layer_norm_bwd_workspace(n, e, *flags)
        if need < 0:
            _cuda.check(-need, "layer_norm_bwd workspace")
        _WORKSPACE_NUMEL[key] = need
    stream = torch.cuda.current_stream(x.device).cuda_stream
    work = _workspace(x.device, stream, need)
    err = lib.bpx_layer_norm_bwd(
        x.data_ptr(), dy.data_ptr(), w.data_ptr(), mu.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        work.data_ptr(), n, e, *flags, stream)
    _cuda.check(err, "layer_norm_bwd")
    layer_norm_backward.launches += 1
    return dx, dw, db


#: fp32 elements of workspace per (device, n, e, flags): the kernel's grid
#: depends on these and on the card alone, so the size is asked of the
#: library once
_WORKSPACE_NUMEL = {}

#: the backward kernel's fp32 workspace (its partial rows of dw and db) per
#: (device, stream), kept at the largest size asked for so far: the grid is
#: sized to the card, so the model's calls all fit one buffer.  Calls on one
#: stream run in order, so they may share it.  This holds for the streams
#: PyTorch hands out, which live as long as the process; a stream destroyed
#: while its work still runs would leave its handle's buffer in use.
_WORKSPACES = {}


def _workspace(device, stream, numel):
    if torch.cuda.is_current_stream_capturing():
        # a buffer from a CUDA graph's private pool must not outlive the
        # graph: the graph owns this one
        return torch.empty(numel, dtype=torch.float32, device=device)
    buf = _WORKSPACES.get((device, stream))
    if buf is None or buf.numel() < numel:
        buf = torch.empty(numel, dtype=torch.float32, device=device)
        _WORKSPACES[(device, stream)] = buf
    return buf


#: kernel launches since the count was last set to 0
layer_norm.launches = 0
layer_norm_backward.launches = 0


class LayerNorm(nn.Module):
    """LayerNorm with fp32 ``weight``/``bias``, a per-site ``eps`` (module
    default 1e-6, as in the JAX package) and output in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, self.dtype)
