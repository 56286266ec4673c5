"""Flash attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain version.

The counterpart is ``bpx/ops/pallas_attention.py::flash_attention`` with
``layout="bhtd"``: q is pre-scaled by ``head_dim**-0.5``; the offset band
``col <= row + |Tk - Tq|`` (from the unpadded lengths, dropped when it is
vacuous) and per-sample key lengths ``kv_lens`` mask scores with -1e30;
the softmax statistics are fp32 and the unnormalised probabilities are cast
to the input dtype before the product with V, divided by the row sum after.
The kernel also returns the log-sum-exp, which the backward of the training
slice needs.  Dropout comes with that slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from bpx_torch.ops import _cuda
from bpx_torch.ops.dispatch import use_kernel
from bpx_torch.ops.masks import band_allowed

MASK_FILL = -1e30
#: head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (64, 96)


def effective_band(tq: int, tk: int, masked: bool):
    """(masked, offset) after dropping a vacuous band: with
    ``offset >= Tk - 1`` every key is visible to every query row."""
    offset = abs(tk - tq)
    return masked and offset < tk - 1, offset


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, masked: bool = True,
                              kv_lens: Optional[torch.Tensor] = None):
    """Plain version on (B, H, T, D) tensors: returns (out, lse), out in
    q's dtype and layout (B, H, Tq, D), lse fp32 (B, H, Tq)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    masked, _ = effective_band(Tq, Tk, masked)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    ok = None
    if kv_lens is not None:
        col = torch.arange(Tk, device=q.device)
        ok = (col[None, :] < kv_lens.to(q.device)[:, None])[:, None, None, :]
    if masked:
        band = band_allowed(Tq, Tk, q.device)
        ok = band if ok is None else ok & band
    if ok is not None:
        s = s.masked_fill(~ok, MASK_FILL)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe).to(q.dtype)
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    masked: bool = True,
                    kv_lens: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0,
                    return_lse: bool = False):
    """(B, H, Tq, D) x (B, H, Tk, D) -> (B, H, Tq, D); q pre-scaled.

    The kernel for CUDA tensors, the plain version for CPU tensors.  The
    kernel takes bf16 with head_dim 64 or 96 and any strides whose last dim
    is contiguous; its output is a (B, H, Tq, D) view of (B, Tq, H, D)
    memory, so ``out.transpose(1, 2).reshape(B, Tq, H * D)`` is free.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout comes with the training slice (ROADMAP.md)")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, T, D)")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kv_lens is not None and kv_lens.shape != (B,):
        raise ValueError(f"kv_lens must be ({B},), got {tuple(kv_lens.shape)}")
    if not use_kernel(q):
        out, lse = flash_attention_reference(q, k, v, masked, kv_lens)
    else:
        out, lse = _launch(q, k, v, masked, kv_lens)
    return (out, lse) if return_lse else out


def _launch(q, k, v, masked, kv_lens):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise RuntimeError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bfloat16, {name} is {t.dtype}")
        if t.stride(3) != 1:
            raise RuntimeError(f"{name}: the last dim must be contiguous")
        if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise RuntimeError(f"{name}: strides must be multiples of 8 "
                               "elements and the data 16-byte aligned")
    if D not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"flash kernel is built for head_dim {KERNEL_HEAD_DIMS}, got {D}")
    masked, offset = effective_band(Tq, Tk, masked)
    kvl_ptr = None
    if kv_lens is not None:
        if kv_lens.device != q.device or kv_lens.dtype != torch.int32:
            raise TypeError("kv_lens must be int32 on q's device")
        kv_lens = kv_lens.contiguous()
        kvl_ptr = kv_lens.data_ptr()
    out = torch.empty(B, Tq, H, D, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    err = _cuda.library().bpx_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), kvl_ptr, B, H, Tq, Tk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(masked), offset, torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "flash_fwd")
    flash_attention.launches += 1
    return out, lse


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
