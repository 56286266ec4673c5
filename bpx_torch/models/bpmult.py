"""BPMulT, the Biprojection Multimodal Transformer (counterpart:
``bpx/models/bpmult.py``): ``mmtrvapt`` (video, audio, poster, text; the
moviescope and mmimdb presets) and ``mmtrvat`` (video, audio, text; iemocap,
cmu-mosei, counseling, cmu-mosi).

Dataflow per target modality X:
  1. encode/project each stream to ``hidden_sz`` (BERT for text; for
     mmtrvapt the conv encoder for audio, mmtrvat takes it raw; bias-free
     projections) and zero-pad it to its static ``num_vectors_*`` length;
  2. 6 first-round crossmodal encoders ``trans_x_with_y``;
  3. 6 second-round encoders ``trans_x_with_y2z`` attending into the
     already-crossed streams: biprojection encoders in mmtrvapt, plain
     crossmodal ones in mmtrvat;
  4. middle Fusion-GMU over the first-round streams (length-adapted in
     mmtrvapt; mmtrvat's equal lengths make its adapters identities),
     level 1->2 residual adds, top Fusion-GMU, level 1->3 residual add;
  5. summary = first + last token of the fused sequence;
  6. an N-ary GMU over the three summaries (and mmtrvapt's poster
     embedding, and with ``hybrid`` the early-fusion summary), or in
     mmtrvat MAG (``fusion="mag"``), then a residual MLP head.
Layout is batch-first ``(B, T, E)`` throughout.

``hybrid`` (the paper's early fusion) adds, after step 1, a linear map of
each padded stream over its sequence axis to ``reduced_dim`` positions, a
self-attention encoder of ``max(layers, 3)`` layers on each, and a 3-ary
GMU over their first + last token summaries, whose output joins the final
GMU (5-ary in mmtrvapt, 4-ary in mmtrvat; not with MAG).
``group_encoders`` builds the 12 crossmodal encoders as 6 pairs of
same-shape encoders (``g_va`` ... ``g_xl2``,
:class:`~bpx_torch.ops.encoder.GroupedTransformerEncoder`), each pair one
encoder over stacked inputs: the same function at eval, half the
attention calls.  Its members share one attention dropout rate, so it
needs ``attn_dropout_a == attn_dropout_v``.

Training mode (``model.train()``, the JAX package's ``deterministic=False``)
turns on the configured dropouts: BERT's, ``embed_dropout`` on the text
stream and inside every encoder, the per-encoder attention dropout rates,
the encoders' ReLU and residual dropout, MAG's, and ``out_dropout`` in the
head.  The forward then takes ``dropout_seed``, a uint32 from which every
dropout site draws its own seed in call order (:class:`SeedStream`), or
the multi-seed step's :class:`SeedStreams`, one seed per vmapped seed.

``remat`` recomputes every encoder layer in the backward instead of keeping
its activations, with ``remat_policy`` (``"save_attn"`` keeps the flash
forwards' outputs); BERT's layers follow ``remat_bert`` (None: ``remat``)
with ``remat_policy_bert``, as in the JAX package
(``ops/encoder.py::recomputed``).  Every mmtrvat preset and mmimdb set
``remat=True``.  ``scan_layers``, ``scan_encoders`` and ``scan_unroll``
steer XLA's program in the JAX package and are inert here: the port runs
eagerly.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bpx_torch.config import ModelConfig
from bpx_torch.ops.audio import make_audio_encoder
from bpx_torch.ops.bert import BertEncoder
from bpx_torch.ops.dropout import maybe_dropout, seed_stream
from bpx_torch.ops.encoder import (GroupedTransformerEncoder,
                                   TransformerEncoder)
from bpx_torch.ops.gmu import GatedBimodalFusionLayer, GatedNModalLayer
from bpx_torch.ops.init import lecun_normal_, linear
from bpx_torch.ops.mag import MAG

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


class _BPMulTBase(nn.Module):
    """What both BPMulT models share: the input encoders and projections,
    the 12-encoder crossmodal mesh, the six Fusion-GMUs, the residual head
    and the forward's pieces.  A subclass builds its modules in the order
    its ``__init__`` calls these (the seeded draws follow that order)."""

    def _setup(self, config: ModelConfig, seed: int, device):
        """Checks, dtype and the seeded generator; returns (gen, device)."""
        cfg = config
        if not (cfg.lonly and cfg.vonly and cfg.aonly):
            raise ValueError("BPMulT requires all three target modalities "
                             "active")
        if cfg.group_encoders and cfg.attn_dropout_a != cfg.attn_dropout_v:
            raise ValueError("group_encoders requires attn_dropout_a == "
                             "attn_dropout_v (pair members share one "
                             "dropout rate)")
        if cfg.hybrid and cfg.fusion == "mag":
            raise ValueError("fusion='mag' is incompatible with hybrid")
        return self._seeded(cfg, seed, device)

    def _seeded(self, config: ModelConfig, seed: int, device):
        """The config, the compute dtype and the generator the weights are
        drawn from (none on the meta device); returns (gen, device)."""
        self.config = config
        self.dtype = compute_dtype(config)
        device = torch.device(device) if device is not None else None
        gen = None
        if device is None or device.type != "meta":
            gen = torch.Generator(device=device or "cpu").manual_seed(seed)
        return gen, device

    def _make_inputs(self, gen, device, streams: str = "lva",
                     with_pooler: bool = False):
        """BERT (with its pooler if ``with_pooler``), the audio encoder
        (when used and "a" is in ``streams``) and the projections to
        ``hidden_sz`` of the ``streams`` (only where the widths differ)."""
        cfg, dt, E = self.config, self.dtype, self.config.hidden_sz
        self.bert = BertEncoder(
            cfg.bert, dt, gen, device,
            cfg.bert_attention_impl or cfg.attention_impl,
            remat=cfg.remat if cfg.remat_bert is None else cfg.remat_bert,
            remat_policy=cfg.remat_policy_bert, with_pooler=with_pooler)
        if cfg.use_audio_encoder and "a" in streams:
            self.audio_enc = make_audio_encoder(
                cfg.audio_encoder, cfg.orig_d_a, cfg.num_vectors_a, dt, gen,
                device)
        proj = lambda d_in: linear(d_in, E, False, "lecun", gen, device)
        for m in streams:
            d_in = getattr(cfg, f"orig_d_{m}")
            if d_in != E:
                setattr(self, f"proj_{m}", proj(d_in))
        return proj

    def _encoder(self, attn_dropout, layers, biprojection, gen, device,
                 cls=TransformerEncoder):
        cfg = self.config
        return cls(cfg.hidden_sz, cfg.num_heads, layers, cfg.attn_mask,
                   biprojection, self.dtype, gen, device, attn_dropout,
                   cfg.relu_dropout, cfg.res_dropout, cfg.embed_dropout,
                   cfg.attention_impl, cfg.remat, cfg.remat_policy)

    def _make_crossmodal_mesh(self, biprojection: bool, gen, device):
        """The 6 first-round crossmodal encoders and the 6 second-round
        ones (biprojection encoders or plain crossmodal ones); with
        ``group_encoders`` the same 12 as 6 pairs."""
        cfg = self.config
        # per-encoder attention dropout: encoders whose query stream is
        # l / a / v take attn_dropout(_a / _v) of the key stream's modality
        rate = {"l": cfg.attn_dropout, "a": cfg.attn_dropout_a,
                "v": cfg.attn_dropout_v}
        if cfg.group_encoders:
            # (pair, key stream, second round): g_va = (v <- a, a <- v),
            # g_xl = (v <- l, a <- l), g_lx = (l <- v, l <- a), g_l_bi =
            # (l <- v2a, l <- a2v), g_x2l = (a <- v2l, v <- a2l), g_xl2 =
            # (a <- l2v, v <- l2a); a pair's rate is its first member's
            for name, key, second in (
                    ("g_va", "a", False), ("g_xl", "l", False),
                    ("g_lx", "v", False), ("g_l_bi", "a", True),
                    ("g_x2l", "l", True), ("g_xl2", "v", True)):
                setattr(self, name, self._encoder(
                    rate[key], cfg.layers, biprojection and second, gen,
                    device, GroupedTransformerEncoder))
            return
        enc = lambda bp, r: self._encoder(r, cfg.layers, bp, gen, device)
        for name, key in (("trans_l_with_a", "a"), ("trans_l_with_v", "v"),
                          ("trans_v_with_l", "l"), ("trans_v_with_a", "a"),
                          ("trans_a_with_l", "l"), ("trans_a_with_v", "v")):
            setattr(self, name, enc(False, rate[key]))
        for name, key in (
                ("trans_l_with_v2a", "a"), ("trans_l_with_a2v", "v"),
                ("trans_v_with_l2a", "a"), ("trans_v_with_a2l", "l"),
                ("trans_a_with_v2l", "l"), ("trans_a_with_l2v", "v")):
            setattr(self, name, enc(biprojection, rate[key]))

    def _make_gmus(self, gen, device):
        for name in ("gmu_l_m", "gmu_v_m", "gmu_a_m", "gmu_l", "gmu_v",
                     "gmu_a"):
            setattr(self, name, GatedBimodalFusionLayer(
                self.config.hidden_sz, self.dtype, gen, device))

    def _make_hybrid(self, gen, device):
        """The early-fusion branch: a self-attention encoder of
        ``max(layers, 3)`` layers per stream, the bias-free sequence-axis
        projections ``proj_{l,v,a}_e`` (T -> ``reduced_dim``) and the 3-ary
        ``gmu_early``."""
        cfg = self.config
        layers = max(cfg.layers, 3)
        for m in "lva":
            setattr(self, f"trans_{m}_early", self._encoder(
                cfg.attn_dropout, layers, False, gen, device))
        for m, T in (("l", cfg.num_vectors_l), ("v", cfg.num_vectors_v),
                     ("a", cfg.num_vectors_a)):
            setattr(self, f"proj_{m}_e",
                    linear(T, cfg.reduced_dim, False, "lecun", gen, device))
        self.gmu_early = GatedNModalLayer(3, cfg.hidden_sz, self.dtype, gen,
                                          device)

    def _make_head(self, gen, device):
        E = self.config.hidden_sz
        self.proj1 = linear(E, E, True, "xavier", gen, device)
        self.proj2 = linear(E, E, True, "xavier", gen, device)
        self.out_layer = linear(E, self.config.n_classes, True, "xavier",
                                gen, device)

    def _lin(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if layer.bias is None else layer.bias.to(dt)
        return nn.functional.linear(x.to(dt), layer.weight.to(dt), b)

    def _encode_streams(self, txt, mask, segment, video, audio, seeds):
        cfg, dt = self.config, self.dtype
        x_l = maybe_dropout(self.bert(txt, mask, segment, seeds).to(dt),
                            cfg.embed_dropout, self.training, seeds)
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

    def _hybrid_summary(self, proj_l, proj_v, proj_a, seeds):
        """Early fusion: each stream mapped over its sequence axis to
        ``reduced_dim`` positions, its early encoder, and the 3-ary GMU over
        the first + last token summaries."""
        dt = self.dtype

        def early(m, x):
            w = getattr(self, f"proj_{m}_e").weight.to(dt)
            return getattr(self, f"trans_{m}_early")(
                torch.matmul(w, x.to(dt)), seeds=seeds)
        h_l = early("l", proj_l)
        h_a = early("a", proj_a)
        h_v = early("v", proj_v)
        summary = lambda h: h[:, 0] + h[:, -1]
        fused, _ = self.gmu_early([summary(h_l), summary(h_v), summary(h_a)])
        return fused

    def _cross(self, name, x, kv, seeds):
        return getattr(self, name)(x, kv, kv, seeds)

    def _pair(self, name, x1, x2, kv1, kv2, seeds):
        """A grouped pair on stacked queries and key/value streams (the
        key/value stack built once, so K and V alias); its two outputs."""
        kv = torch.stack([kv1, kv2])
        h = getattr(self, name)(torch.stack([x1, x2]), kv, kv, seeds)
        return h[0], h[1]

    def _first_round(self, proj_l, proj_v, proj_a, seeds):
        """(h_v_with_as, h_a_with_vs, h_v_with_ls, h_l_with_vs,
        h_a_with_ls, h_l_with_as), in the JAX package's call order."""
        if self.config.group_encoders:
            pair = lambda *a: self._pair(*a, seeds)
            h_v_with_as, h_a_with_vs = pair("g_va", proj_v, proj_a, proj_a,
                                            proj_v)
            h_v_with_ls, h_a_with_ls = pair("g_xl", proj_v, proj_a, proj_l,
                                            proj_l)
            h_l_with_vs, h_l_with_as = pair("g_lx", proj_l, proj_l, proj_v,
                                            proj_a)
            return (h_v_with_as, h_a_with_vs, h_v_with_ls, h_l_with_vs,
                    h_a_with_ls, h_l_with_as)
        cross = lambda name, x, kv: self._cross(name, x, kv, seeds)
        return (cross("trans_v_with_a", proj_v, proj_a),
                cross("trans_a_with_v", proj_a, proj_v),
                cross("trans_v_with_l", proj_v, proj_l),
                cross("trans_l_with_v", proj_l, proj_v),
                cross("trans_a_with_l", proj_a, proj_l),
                cross("trans_l_with_a", proj_l, proj_a))

    def _second_round(self, proj_l, proj_v, proj_a, first, seeds):
        """(h_l_v2a, h_l_a2v, h_a_v2l, h_a_l2v, h_v_a2l, h_v_l2a)."""
        (h_v_with_as, h_a_with_vs, h_v_with_ls, h_l_with_vs, h_a_with_ls,
         h_l_with_as) = first
        if self.config.group_encoders:
            pair = lambda *a: self._pair(*a, seeds)
            h_l_v2a, h_l_a2v = pair("g_l_bi", proj_l, proj_l, h_a_with_vs,
                                    h_v_with_as)
            h_a_v2l, h_v_a2l = pair("g_x2l", proj_a, proj_v, h_l_with_vs,
                                    h_l_with_as)
            h_a_l2v, h_v_l2a = pair("g_xl2", proj_a, proj_v, h_v_with_ls,
                                    h_a_with_ls)
            return h_l_v2a, h_l_a2v, h_a_v2l, h_a_l2v, h_v_a2l, h_v_l2a
        cross = lambda name, x, kv: self._cross(name, x, kv, seeds)
        return (cross("trans_l_with_v2a", proj_l, h_a_with_vs),
                cross("trans_l_with_a2v", proj_l, h_v_with_as),
                cross("trans_a_with_v2l", proj_a, h_l_with_vs),
                cross("trans_a_with_l2v", proj_a, h_v_with_ls),
                cross("trans_v_with_a2l", proj_v, h_l_with_as),
                cross("trans_v_with_l2a", proj_v, h_a_with_ls))

    @staticmethod
    def _fuse_target(bi1, bi2, t1, t2, gmu_m, gmu_top, flip=False,
                     last_only=False):
        """Middle GMU, level 1->2 residuals, top GMU, level 1->3 residual
        and the first+last-token summary of one target (the last token
        alone with ``last_only``, as the notebook-era ``tmmtrvpa`` sums
        up).  ``flip`` gives target L's reversed GMU argument order (the
        GMU slots are asymmetric weights, so the order is part of the
        function)."""
        h_gmu, _ = gmu_m(t2, t1) if flip else gmu_m(t1, t2)
        tot1 = bi1 + t1
        tot2 = bi2 + t2
        h_top, _ = gmu_top(tot2, tot1) if flip else gmu_top(tot1, tot2)
        h_top = h_top + h_gmu
        if last_only:
            return h_top[:, -1]
        return h_top[:, 0] + h_top[:, -1]

    def _targets(self, second, l_streams, a_streams, v_streams,
                 last_only=False):
        """(last_h_l, last_h_v, last_h_a) from the second round and each
        target's two (length-adapted) first-round streams."""
        h_l_v2a, h_l_a2v, h_a_v2l, h_a_l2v, h_v_a2l, h_v_l2a = second
        fuse = lambda *a, **k: self._fuse_target(*a, last_only=last_only,
                                                 **k)
        last_h_l = fuse(h_l_v2a, h_l_a2v, *l_streams, self.gmu_l_m,
                        self.gmu_l, flip=True)
        last_h_a = fuse(h_a_v2l, h_a_l2v, *a_streams, self.gmu_a_m,
                        self.gmu_a)
        last_h_v = fuse(h_v_a2l, h_v_l2a, *v_streams, self.gmu_v_m,
                        self.gmu_v)
        return last_h_l, last_h_v, last_h_a

    def _head(self, last_hs: torch.Tensor, seeds) -> torch.Tensor:
        h = torch.relu(self._lin(self.proj1, last_hs))
        h = maybe_dropout(h, self.config.out_dropout, self.training, seeds)
        h = self._lin(self.proj2, h)
        return self._lin(self.out_layer, h + last_hs)


class BPMulTVAPT(_BPMulTBase):
    """``mmtrvapt``: BPMulT over video, audio, poster and text."""

    def __init__(self, config: ModelConfig, seed: int = 0, device=None):
        super().__init__()
        gen, device = self._setup(config, seed, device)
        cfg = config
        if cfg.num_vectors_a != cfg.num_vectors_v:
            raise ValueError("mmtrvapt assumes num_vectors_a == "
                             "num_vectors_v")
        if cfg.fusion != "gmu":
            raise ValueError("fusion='mag' is only wired on mmtrvat")
        proj = self._make_inputs(gen, device)
        self.proj_poster = proj(cfg.orig_d_p)
        self._make_crossmodal_mesh(True, gen, device)
        self._make_gmus(gen, device)
        dt = self.dtype
        Tl, Ta, Tv = cfg.num_vectors_l, cfg.num_vectors_a, cfg.num_vectors_v
        self.transfm_a2l = SeqAdapter(Ta, Tl, dt, gen, device)
        self.transfm_v2l = SeqAdapter(Tv, Tl, dt, gen, device)
        self.transfm_l2a = SeqAdapter(Tl, Ta, dt, gen, device)
        self.transfm_l2v = SeqAdapter(Tl, Tv, dt, gen, device)
        self.gmu = GatedNModalLayer(5 if cfg.hybrid else 4, cfg.hidden_sz, dt,
                                    gen, device)
        if cfg.hybrid:
            self._make_hybrid(gen, device)
        self._make_head(gen, device)

    def forward(self, txt, mask, segment, video, audio, poster,
                output_gates: bool = False,
                dropout_seed: Optional[int] = None):
        """Logits (and the final GMU's gates); ``dropout_seed`` (uint32) is
        needed in training mode."""
        seeds = seed_stream(dropout_seed)
        proj_l, proj_v, proj_a = self._encode_streams(txt, mask, segment,
                                                      video, audio, seeds)
        early = (self._hybrid_summary(proj_l, proj_v, proj_a, seeds)
                 if self.config.hybrid else None)
        poster_h = self._lin(self.proj_poster, poster)
        first = self._first_round(proj_l, proj_v, proj_a, seeds)
        second = self._second_round(proj_l, proj_v, proj_a, first, seeds)
        (h_v_with_as, h_a_with_vs, h_v_with_ls, h_l_with_vs, h_a_with_ls,
         h_l_with_as) = first
        # target L: both first-round streams length-adapted to
        # num_vectors_l; target A: the l-stream adapted to num_vectors_a, v
        # passes through; target V likewise
        last_h_l, last_h_v, last_h_a = self._targets(
            second,
            (self.transfm_a2l(h_a_with_vs), self.transfm_v2l(h_v_with_as)),
            (self.transfm_l2a(h_l_with_vs), h_v_with_ls),
            (self.transfm_l2v(h_l_with_as), h_a_with_ls))
        inputs = [last_h_l, last_h_v, last_h_a, poster_h]
        last_hs, z = self.gmu(inputs if early is None else inputs + [early])
        logits = self._head(last_hs, seeds)
        if output_gates:
            return logits, z
        return logits


class BPMulTVAT(_BPMulTBase):
    """``mmtrvat``: BPMulT over video, audio and text.  Audio is taken raw,
    there is no poster, the stream lengths are equal (so the length
    adapters are identities and there are no ``transfm_*``), the second
    round is plain crossmodal encoders, and the final fusion is a 3-ary GMU
    or MAG (``fusion="mag"``; its gates are MAG's alpha, (B, 1))."""

    def __init__(self, config: ModelConfig, seed: int = 0, device=None):
        super().__init__()
        gen, device = self._setup(config, seed, device)
        cfg = config
        if not cfg.num_vectors_l == cfg.num_vectors_a == cfg.num_vectors_v:
            raise ValueError("mmtrvat uses identity length adapters; stream "
                             "lengths must match")
        if cfg.use_audio_encoder:
            raise ValueError("mmtrvat takes raw audio "
                             "(use_audio_encoder=False)")
        if cfg.fusion not in ("gmu", "mag"):
            raise ValueError(f"unknown fusion {cfg.fusion!r}")
        self._make_inputs(gen, device)
        self._make_crossmodal_mesh(False, gen, device)
        self._make_gmus(gen, device)
        if cfg.fusion == "mag":
            self.mag = MAG(cfg.hidden_sz, beta_shift=1e-3, dropout_prob=0.5,
                           dtype=self.dtype, gen=gen, device=device)
        else:
            self.gmu = GatedNModalLayer(4 if cfg.hybrid else 3,
                                        cfg.hidden_sz, self.dtype, gen,
                                        device)
        if cfg.hybrid:
            self._make_hybrid(gen, device)
        self._make_head(gen, device)

    def forward(self, txt, mask, segment, video, audio,
                output_gates: bool = False,
                dropout_seed: Optional[int] = None):
        """Logits (and the final fusion's gates); ``dropout_seed`` (uint32)
        is needed in training mode."""
        seeds = seed_stream(dropout_seed)
        proj_l, proj_v, proj_a = self._encode_streams(txt, mask, segment,
                                                      video, audio, seeds)
        early = (self._hybrid_summary(proj_l, proj_v, proj_a, seeds)
                 if self.config.hybrid else None)
        first = self._first_round(proj_l, proj_v, proj_a, seeds)
        second = self._second_round(proj_l, proj_v, proj_a, first, seeds)
        (h_v_with_as, h_a_with_vs, h_v_with_ls, h_l_with_vs, h_a_with_ls,
         h_l_with_as) = first
        last_h_l, last_h_v, last_h_a = self._targets(
            second, (h_a_with_vs, h_v_with_as), (h_l_with_vs, h_v_with_ls),
            (h_l_with_as, h_a_with_ls))
        if self.config.fusion == "mag":
            last_hs, z = self.mag(last_h_l, last_h_v, last_h_a, seeds)
        else:
            inputs = [last_h_l, last_h_v, last_h_a]
            last_hs, z = self.gmu(inputs if early is None
                                  else inputs + [early])
        logits = self._head(last_hs, seeds)
        if output_gates:
            return logits, z
        return logits
