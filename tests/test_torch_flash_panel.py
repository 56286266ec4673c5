"""The panel route: bf16 at every head dim from 1 to 256 that the tabled
kernels do not take, on the card the panel builds of the tabled kernels
(``csrc/flash_panel_fwd.cu``, ``csrc/flash_panel_bwd.cu``: the narrow,
wide and tall kernels at the panel width that holds the head dim, with the
head dim a runtime argument).

Here, on the CPU, no kernel runs: the route table and the panel widths at
every head dim, the wrapper's handling of the views (none copied), the C
entry points' argument lists as the wrappers build them (through a stand-in
library that records each call, against the argument types
``bpx_torch/ops/_cuda.py`` declares), the counters by route, and the plain
versions in bf16 at one head dim of each panel width against bpx's Pallas
kernels in interpret mode.  Inputs are made with numpy from a seed; bf16
within 2e-2 of each tensor's largest entry, as
``tests/test_torch_flash_generic.py``'s bf16 test.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpx_torch.ops import _cuda
from bpx_torch.ops import flash_attention as tflash
from tests.test_torch_flash_attention import _bpx_fwd_vjp, _inputs
from tests.test_torch_loop import few_threads  # noqa: F401

UNTABLED = [d for d in range(1, 257) if d not in tflash.KERNEL_ALIGN]


@pytest.mark.parametrize("D", UNTABLED)
def test_panel_width(D):
    """bf16 at an untabled head dim from 1 to 256 takes the panel route at
    the smallest of 32, 64, 128, 192 and 256 that holds it; fp32 at the
    same head dim the generic kernels."""
    w = tflash.panel_width(D)
    assert w == min(x for x in (32, 64, 128, 192, 256) if x >= D)
    assert tflash.kernel_route(torch.bfloat16, D) == "panel"
    assert tflash.kernel_route(torch.float32, D) == "generic"


def test_panel_route_takes_strided_views_uncopied():
    """Every view whose last dim is contiguous goes to the panel builds as
    it is: a fused (B, T, 3, H, D) projection's views at odd head dims
    above 32 (rows at any even byte: the 2-byte loads), at an even one
    (4-byte words) and at one whose rows are 16-byte aligned (chunks);
    a view whose last dim is strided is copied."""
    for D in (33, 65, 129, 193, 34, 48, 1):
        buf = torch.zeros(2, 9, 3, 4, D, dtype=torch.bfloat16)
        for i in range(3):
            t = buf[:, :, i].transpose(1, 2)
            assert tflash.kernel_route(t.dtype, D) == "panel"
            assert tflash._kernel_ready("t", t, t.device) is t
            assert tflash._kernel_ready("t", t, t.device, "panel") is t
        part = torch.zeros(2, 4, 9, D + 1, dtype=torch.bfloat16)[..., 1:]
        assert tflash._kernel_ready("t", part, part.device) is part
    strided = torch.zeros(2, 4, 9, 96, dtype=torch.bfloat16)[..., ::2]
    ready = tflash._kernel_ready("t", strided, strided.device, "panel")
    assert ready is not strided and ready.stride(3) == 1
    assert torch.equal(ready, strided)


class _Entry:
    """A C entry point that records its arguments and returns 0."""

    def __init__(self, calls, name):
        self.calls, self.name = calls, name
        self.argtypes, self.restype = None, None

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return 0


class _Library:
    """A stand-in for the kernel library: every attribute an entry point
    that records its calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        entry = _Entry(self.calls, name)
        setattr(self, name, entry)
        return entry


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' launches on CPU tensors through a stand-in library
    whose entry points carry ``_cuda._declare``'s argument types."""
    lib = _Library()
    _cuda._declare(lib)
    lib.calls.clear()
    monkeypatch.setattr(_cuda, "library", lambda: lib)

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    return lib


def _fused(D, B=2, H=3, T=70):
    """q, k, v as (B, H, T, D) bf16 views of one fused projection."""
    buf = torch.zeros(B, T, 3, H, D, dtype=torch.bfloat16)
    return tuple(buf[:, :, i].transpose(1, 2) for i in range(3))


def _check_args(lib, name, args, D):
    """The call's arguments fit the entry's declared types, one for one,
    with the head dim where ``_dims`` puts it (after B, H, Tq, Tk; after
    B, H, T for delta)."""
    entry = getattr(lib, name)
    assert len(args) == len(entry.argtypes), name
    ints = [a for a, t in zip(args, entry.argtypes) if t is ctypes.c_int]
    assert D in ints, (name, ints)
    for a, t in zip(args, entry.argtypes):
        if t in (ctypes.c_int, ctypes.c_longlong, ctypes.c_uint):
            assert isinstance(a, int), (name, a, t)
    return args


@pytest.mark.parametrize("D", [1, 17, 33, 48, 65, 100, 129, 160, 193, 224,
                               255])
def test_panel_entries_take_the_arguments_dims_builds(recorded, D):
    """The forward, the backward and the standalone delta on the panel
    route call ``bpx_flash_panel_fwd``, ``bpx_flash_panel_bwd`` and
    ``bpx_flash_panel_delta`` with as many arguments as ``_cuda`` declares
    and the head dim alone as ``_dims`` builds it (no dtype code), copy
    none of a fused projection's views, and count one launch each on the
    panel route and none on the generic one."""
    assert tflash._dims("panel", D, torch.bfloat16) == (D,)
    assert tflash._dims("generic", D, torch.float32) == (D, 1)
    q, k, v = _fused(D)
    counters = (tflash.flash_attention, tflash.flash_attention_backward,
                tflash.attention_delta)
    before = [(c.launches, c.panel_launches, c.generic_launches)
              for c in counters]
    out, lse = tflash._launch(q, k, v, True, None, 0.1, 0x5EED)
    tflash._launch_bwd(q, k, v, out, lse, out, True, None, 0.1, 0x5EED)
    tflash._launch_delta(out, out)
    names = [n for n, _ in recorded.calls]
    assert names == ["bpx_flash_panel_fwd", "bpx_flash_panel_bwd",
                     "bpx_flash_panel_delta"]
    fwd, bwd, delta = (_check_args(recorded, n, a, D)
                       for n, a in recorded.calls)
    assert fwd[:3] == tuple(t.data_ptr() for t in (q, k, v))
    assert fwd[6:11] == (2, 3, 70, 70, D)
    assert bwd[:3] == fwd[:3] and bwd[11:16] == (2, 3, 70, 70, D)
    assert delta[3:7] == (2, 3, 70, D)
    after = [(c.launches, c.panel_launches, c.generic_launches)
             for c in counters]
    assert [tuple(a - b for a, b in zip(x, y))
            for x, y in zip(after, before)] == [(1, 1, 0)] * 3


@pytest.mark.parametrize("D", [17, 40, 100, 150, 200])
def test_panel_head_dims_in_bf16_match_pallas(D):
    """bf16 at one untabled head dim of each panel width (an odd one at
    32), both sides in bf16, band offset 30, ``kv_lens`` with an empty row
    and dropout 0.2: the port's output and gradients against bpx's
    within 2e-2 of each tensor's largest entry (two bf16 ulps at the casts
    of P, dS and the outputs)."""
    B, H, Tq, Tk = 2, 2, 70, 100
    q, k, v = (x.astype(jnp.bfloat16) for x in _inputs(B, H, Tq, Tk, D,
                                                       seed=D + 5))
    dout = np.random.RandomState(D + 6).randn(B, H, Tq, D).astype(
        jnp.bfloat16)
    kv = np.asarray((100, 0), np.int32)
    want = _bpx_fwd_vjp(q, k, v, dout, True, kv, 0.2, 0xBA4E + D)
    bf = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16)
    qt, kt, vt = (bf(x).requires_grad_(True) for x in (q, k, v))
    out = tflash.flash_attention(qt, kt, vt, True, torch.from_numpy(kv), 0.2,
                                 0xBA4E + D)
    out.backward(bf(dout))
    for name, g, w in zip(("out", "dq", "dk", "dv"),
                          (out, qt.grad, kt.grad, vt.grad), want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=2e-2,
                                   atol=2e-2 * max(1.0, np.abs(w).max()),
                                   err_msg=name)
