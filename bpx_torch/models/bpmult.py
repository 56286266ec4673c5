"""BPMulT, the Biprojection Multimodal Transformer (counterpart:
``bpx/models/bpmult.py``); this slice ports ``mmtrvapt``.

Dataflow per target modality X:
  1. encode/project each stream to ``hidden_sz`` (BERT for text, the conv
     encoder for audio, bias-free projections) and zero-pad it to its static
     ``num_vectors_*`` length;
  2. 6 first-round crossmodal encoders ``trans_x_with_y``;
  3. 6 biprojection encoders ``trans_x_with_y2z`` attending into the
     already-crossed streams;
  4. middle Fusion-GMU over the (length-adapted) first-round streams,
     level 1->2 residual adds, top Fusion-GMU, level 1->3 residual add;
  5. summary = first + last token of the fused sequence;
  6. a 4-input GMU over the three summaries and the poster embedding, then
     a residual MLP head.
Layout is batch-first ``(B, T, E)`` throughout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bpx_torch.config import ModelConfig
from bpx_torch.ops.audio import make_audio_encoder
from bpx_torch.ops.bert import BertEncoder
from bpx_torch.ops.encoder import TransformerEncoder
from bpx_torch.ops.gmu import GatedBimodalFusionLayer, GatedNModalLayer
from bpx_torch.ops.init import lecun_normal_, linear

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def _pad_to_length(x: torch.Tensor, length: int) -> torch.Tensor:
    """Zero-pad (B, T, E) along T to ``length``."""
    T = x.shape[1]
    if T > length:
        raise ValueError(f"stream length {T} exceeds configured {length}")
    if T == length:
        return x
    return nn.functional.pad(x, (0, 0, 0, length - T))


class SeqAdapter(nn.Module):
    """Linear map over the sequence axis: (B, T_in, E) -> (B, T_out, E),
    with a (T_out, T_in) ``weight`` (the JAX kernel's layout and init)."""

    def __init__(self, t_in: int, t_out: int, dtype: torch.dtype,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(t_out, t_in, device=device))
        self.bias = nn.Parameter(torch.zeros(t_out, device=device))
        # flax's lecun_normal reads the fan-in off axis -2 of the kernel
        lecun_normal_(self.weight, t_out, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(self.weight.to(self.dtype), x).to(x.dtype)
        return y + self.bias.to(x.dtype)[None, :, None]


class BPMulTVAPT(nn.Module):
    """``mmtrvapt``: BPMulT over video, audio, poster and text."""

    def __init__(self, config: ModelConfig, seed: int = 0, device=None):
        super().__init__()
        cfg = config
        if not (cfg.lonly and cfg.vonly and cfg.aonly):
            raise ValueError("BPMulT requires all three target modalities "
                             "active")
        if cfg.num_vectors_a != cfg.num_vectors_v:
            raise ValueError("mmtrvapt assumes num_vectors_a == "
                             "num_vectors_v")
        if cfg.fusion != "gmu":
            raise ValueError("fusion='mag' is only wired on mmtrvat")
        if cfg.group_encoders:
            raise NotImplementedError(
                "group_encoders is not ported yet (ROADMAP.md, port queue)")
        if cfg.hybrid:
            raise NotImplementedError(
                "hybrid early fusion is not ported yet (ROADMAP.md, port "
                "queue)")
        self.config = cfg
        dt = self.dtype = compute_dtype(cfg)
        device = torch.device(device) if device is not None else None
        gen = None
        if device is None or device.type != "meta":
            gen = torch.Generator(device=device or "cpu").manual_seed(seed)
        E = cfg.hidden_sz

        self.bert = BertEncoder(cfg.bert, dt, gen, device)
        if cfg.use_audio_encoder:
            self.audio_enc = make_audio_encoder(
                cfg.audio_encoder, cfg.orig_d_a, cfg.num_vectors_a, dt, gen,
                device)
        proj = lambda d_in: linear(d_in, E, False, "lecun", gen, device)
        if cfg.orig_d_l != E:
            self.proj_l = proj(cfg.orig_d_l)
        if cfg.orig_d_v != E:
            self.proj_v = proj(cfg.orig_d_v)
        if cfg.orig_d_a != E:
            self.proj_a = proj(cfg.orig_d_a)
        self.proj_poster = proj(cfg.orig_d_p)

        def enc(biprojection):
            return TransformerEncoder(E, cfg.num_heads, cfg.layers,
                                      cfg.attn_mask, biprojection, dt, gen,
                                      device)
        for name in ("trans_l_with_a", "trans_l_with_v", "trans_v_with_l",
                     "trans_v_with_a", "trans_a_with_l", "trans_a_with_v"):
            setattr(self, name, enc(False))
        for name in ("trans_l_with_v2a", "trans_l_with_a2v",
                     "trans_v_with_l2a", "trans_v_with_a2l",
                     "trans_a_with_v2l", "trans_a_with_l2v"):
            setattr(self, name, enc(True))

        for name in ("gmu_l_m", "gmu_v_m", "gmu_a_m", "gmu_l", "gmu_v",
                     "gmu_a"):
            setattr(self, name, GatedBimodalFusionLayer(E, dt, gen, device))

        Tl, Ta, Tv = cfg.num_vectors_l, cfg.num_vectors_a, cfg.num_vectors_v
        self.transfm_a2l = SeqAdapter(Ta, Tl, dt, gen, device)
        self.transfm_v2l = SeqAdapter(Tv, Tl, dt, gen, device)
        self.transfm_l2a = SeqAdapter(Tl, Ta, dt, gen, device)
        self.transfm_l2v = SeqAdapter(Tl, Tv, dt, gen, device)

        self.gmu = GatedNModalLayer(4, E, dt, gen, device)
        self.proj1 = linear(E, E, True, "xavier", gen, device)
        self.proj2 = linear(E, E, True, "xavier", gen, device)
        self.out_layer = linear(E, cfg.n_classes, True, "xavier", gen, device)

    def _lin(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if layer.bias is None else layer.bias.to(dt)
        return nn.functional.linear(x.to(dt), layer.weight.to(dt), b)

    def _encode_streams(self, txt, mask, segment, video, audio):
        cfg, dt = self.config, self.dtype
        x_l = self.bert(txt, mask, segment).to(dt)
        x_v = video.to(dt)
        x_a = (self.audio_enc(audio.to(dt)) if cfg.use_audio_encoder
               else audio.to(dt))
        E = cfg.hidden_sz
        proj_l = x_l if cfg.orig_d_l == E else self._lin(self.proj_l, x_l)
        proj_a = x_a if cfg.orig_d_a == E else self._lin(self.proj_a, x_a)
        proj_v = x_v if cfg.orig_d_v == E else self._lin(self.proj_v, x_v)
        return (_pad_to_length(proj_l, cfg.num_vectors_l),
                _pad_to_length(proj_v, cfg.num_vectors_v),
                _pad_to_length(proj_a, cfg.num_vectors_a))

    @staticmethod
    def _fuse_target(bi1, bi2, t1, t2, gmu_m, gmu_top, flip=False):
        """Middle GMU, level 1->2 residuals, top GMU, level 1->3 residual
        and the first+last-token summary of one target.  ``flip`` gives
        target L's reversed GMU argument order (the GMU slots are
        asymmetric weights, so the order is part of the function)."""
        h_gmu, _ = gmu_m(t2, t1) if flip else gmu_m(t1, t2)
        tot1 = bi1 + t1
        tot2 = bi2 + t2
        h_top, _ = gmu_top(tot2, tot1) if flip else gmu_top(tot1, tot2)
        h_top = h_top + h_gmu
        return h_top[:, 0] + h_top[:, -1]

    def _head(self, last_hs: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self._lin(self.proj1, last_hs))
        h = self._lin(self.proj2, h)
        return self._lin(self.out_layer, h + last_hs)

    def forward(self, txt, mask, segment, video, audio, poster,
                output_gates: bool = False):
        proj_l, proj_v, proj_a = self._encode_streams(txt, mask, segment,
                                                      video, audio)
        poster_h = self._lin(self.proj_poster, poster)

        h_v_with_as = self.trans_v_with_a(proj_v, proj_a, proj_a)
        h_a_with_vs = self.trans_a_with_v(proj_a, proj_v, proj_v)
        h_v_with_ls = self.trans_v_with_l(proj_v, proj_l, proj_l)
        h_l_with_vs = self.trans_l_with_v(proj_l, proj_v, proj_v)
        h_a_with_ls = self.trans_a_with_l(proj_a, proj_l, proj_l)
        h_l_with_as = self.trans_l_with_a(proj_l, proj_a, proj_a)

        h_l_v2a = self.trans_l_with_v2a(proj_l, h_a_with_vs, h_a_with_vs)
        h_l_a2v = self.trans_l_with_a2v(proj_l, h_v_with_as, h_v_with_as)
        h_a_v2l = self.trans_a_with_v2l(proj_a, h_l_with_vs, h_l_with_vs)
        h_a_l2v = self.trans_a_with_l2v(proj_a, h_v_with_ls, h_v_with_ls)
        h_v_a2l = self.trans_v_with_a2l(proj_v, h_l_with_as, h_l_with_as)
        h_v_l2a = self.trans_v_with_l2a(proj_v, h_a_with_ls, h_a_with_ls)

        # target L: both first-round streams length-adapted to num_vectors_l
        last_h_l = self._fuse_target(
            h_l_v2a, h_l_a2v, self.transfm_a2l(h_a_with_vs),
            self.transfm_v2l(h_v_with_as), self.gmu_l_m, self.gmu_l,
            flip=True)
        # target A: the l-stream adapted to num_vectors_a, v passes through
        last_h_a = self._fuse_target(
            h_a_v2l, h_a_l2v, self.transfm_l2a(h_l_with_vs), h_v_with_ls,
            self.gmu_a_m, self.gmu_a)
        # target V
        last_h_v = self._fuse_target(
            h_v_a2l, h_v_l2a, self.transfm_l2v(h_l_with_as), h_a_with_ls,
            self.gmu_v_m, self.gmu_v)

        last_hs, z = self.gmu([last_h_l, last_h_v, last_h_a, poster_h])
        logits = self._head(last_hs)
        if output_gates:
            return logits, z
        return logits
