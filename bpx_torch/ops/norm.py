"""LayerNorm: the CUDA kernel ``csrc/layer_norm.cu`` and its plain version.

The counterpart is ``bpx/ops/norm.py``: fp32 statistics over the whole last
axis (two-pass variance), fp32 weight and bias, output cast to the module's
compute dtype.  The kernel replaces ``_ln_fwd_kernel``; the backward comes
with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from bpx_torch.ops import _cuda
from bpx_torch.ops.dispatch import use_kernel

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


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float, out_dtype: Optional[torch.dtype] = None,
               return_stats: bool = False):
    """LayerNorm over the last axis; the kernel for a CUDA tensor, the plain
    version for a CPU tensor.  ``return_stats`` adds the fp32 (mu, rstd)."""
    out_dtype = out_dtype or x.dtype
    e = x.shape[-1]
    if w.shape != (e,) or b.shape != (e,):
        raise ValueError(f"weight/bias must be ({e},), got "
                         f"{tuple(w.shape)} / {tuple(b.shape)}")
    if not use_kernel(x):
        y, mu, rstd = layer_norm_reference(x, w, b, eps, out_dtype)
    else:
        y, mu, rstd = _launch(x, w, b, eps, out_dtype)
    return (y, mu, rstd) if return_stats else y


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


#: kernel launches since the count was last set to 0
layer_norm.launches = 0


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
