"""The notebook-era models (counterpart: ``bpx/models/legacy.py``), the
ancestors of BPMulT and the baselines of the reference's demo notebooks:

* :class:`MulTGMUClf` (``mmtrvpa``): six crossmodal encoders; per target
  the two crossed streams concatenated to 2E and a 2E-wide self-attention
  "memory" encoder of ``max(layers, 3)`` layers (with ``attention_impl``
  "pallas" its head dim is 2E / heads: 192 at moviescope's widths, 50 at
  iemocap's, 60 at cmu-mosei's, counseling's and cmu-mosi's, 256 at
  mmimdb's); the last token of each, a 3-ary GMU over the three 2E
  summaries, the residual head;
* :class:`TranslatingMMTGMUClf` (``tmmtrvpa``): BPMulT's first round and a
  plain crossmodal second round, the middle and top Fusion-GMUs with the
  level 1->2 residuals, the last token of each target, a 3-ary GMU, the
  residual head;
* :class:`GMUClf` (``gmu``, and with ``gmu_variant`` "hierarchical" /
  "softmax" ``gmu_hier`` / ``gmu_softmax``): BERT's pooled [CLS] output
  and the mean over time of the projected video and audio, one GMU, one
  linear layer;
* :class:`GMUBimodalClf` (``gmu_bi``): text and video only;
* :class:`BertClf` (``bertclf``, ``bert``): BERT's pooled output and one
  linear layer; with ``output_gates`` a gate array of width 0.

The modules keep the JAX package's names, so ``interop.params_from_flax``
carries its trees with its generic rules.  What the JAX package's classes
check, these check: ``tmmtrvpa`` needs ``num_vectors_a == num_vectors_v``
and refuses ``group_encoders``.  ``hybrid`` and ``fusion``, which the JAX
package's classes never read, these accept and ignore too (with a logged
warning): the model built is the one the JAX package builds, its parameter
tree unchanged.

In training mode the forward draws every dropout site's seed from one
:class:`~bpx_torch.ops.dropout.SeedStream` in call order, as the BPMulT
models do: BERT's, the text stream's embedding dropout, and in each
encoder (the memory encoders too) the embedding, attention, ReLU and
residual dropouts, then ``out_dropout`` in the residual head.  The GMU
classifiers drop only inside BERT.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from bpx_torch.config import ModelConfig
from bpx_torch.models.bpmult import SeqAdapter, _BPMulTBase
from bpx_torch.ops.dropout import seed_stream
from bpx_torch.ops.encoder import TransformerEncoder
from bpx_torch.ops.gmu import (GatedBimodalLayer, GatedHierarchicalLayer,
                               GatedNModalLayer, GatedSoftmaxLayer)
from bpx_torch.ops.init import linear


class _LegacyBase(_BPMulTBase):
    """What the notebook-era models share: the dtype and seeded generator
    of the BPMulT models, and the options they ignore."""

    def _legacy_setup(self, config: ModelConfig, seed: int, device):
        ignored = ["hybrid"] if config.hybrid else []
        if config.fusion != "gmu":
            ignored.append(f"fusion={config.fusion!r}")
        for option in ignored:
            logging.getLogger(__name__).warning(
                "%s ignores %s, as the JAX package's model does",
                config.model, option)
        return self._seeded(config, seed, device)

    def _gates_or_logits(self, logits, z, output_gates):
        return (logits, z) if output_gates else logits

    def _mean_stream(self, m: str, x: torch.Tensor) -> torch.Tensor:
        """A stream projected to ``hidden_sz`` (where its width differs),
        averaged over time."""
        if getattr(self.config, f"orig_d_{m}") != self.config.hidden_sz:
            x = self._lin(getattr(self, f"proj_{m}"), x)
        return x.mean(1)


class MulTGMUClf(_LegacyBase):
    """``mmtrvpa``: MulT with GMU late fusion."""

    def __init__(self, config: ModelConfig, seed: int = 0, device=None):
        super().__init__()
        gen, device = self._legacy_setup(config, seed, device)
        cfg, dt, E = config, self.dtype, config.hidden_sz
        self._make_inputs(gen, device)
        enc = lambda rate: self._encoder(rate, cfg.layers, False, gen,
                                         device)
        for name, rate in (("trans_l_with_a", cfg.attn_dropout_a),
                           ("trans_l_with_v", cfg.attn_dropout_v),
                           ("trans_v_with_l", cfg.attn_dropout),
                           ("trans_v_with_a", cfg.attn_dropout_a),
                           ("trans_a_with_l", cfg.attn_dropout),
                           ("trans_a_with_v", cfg.attn_dropout_v)):
            setattr(self, name, enc(rate))
        # the 2E-wide memory encoders: depth max(layers, 3), attn_dropout,
        # never recomputed (the JAX package builds them without remat)
        for m in "lva":
            setattr(self, f"trans_{m}_mem", TransformerEncoder(
                2 * E, cfg.num_heads, max(cfg.layers, 3), cfg.attn_mask,
                False, dt, gen, device, cfg.attn_dropout, cfg.relu_dropout,
                cfg.res_dropout, cfg.embed_dropout, cfg.attention_impl))
        self.gmu = GatedNModalLayer(3, E, dt, gen, device,
                                    in_features=[2 * E] * 3)
        self._make_head(gen, device)

    def forward(self, txt, mask, segment, video, audio,
                output_gates: bool = False,
                dropout_seed: Optional[int] = None):
        seeds = seed_stream(dropout_seed)
        proj_l, proj_v, proj_a = self._encode_streams(txt, mask, segment,
                                                      video, audio, seeds)
        cross = lambda name, x, kv: self._cross(name, x, kv, seeds)

        def summary(m, x, k1, kv1, k2, kv2):
            h = torch.cat([cross(f"trans_{m}_with_{k1}", x, kv1),
                           cross(f"trans_{m}_with_{k2}", x, kv2)], -1)
            return getattr(self, f"trans_{m}_mem")(h, seeds=seeds)[:, -1]

        last_h_l = summary("l", proj_l, "a", proj_a, "v", proj_v)
        last_h_a = summary("a", proj_a, "l", proj_l, "v", proj_v)
        last_h_v = summary("v", proj_v, "l", proj_l, "a", proj_a)
        last_hs, z = self.gmu([last_h_l, last_h_v, last_h_a])
        return self._gates_or_logits(self._head(last_hs, seeds), z,
                                     output_gates)


class TranslatingMMTGMUClf(_LegacyBase):
    """``tmmtrvpa``: Translating MMT with GMU fusion, the single-projection
    ancestor of BPMulT."""

    def __init__(self, config: ModelConfig, seed: int = 0, device=None):
        super().__init__()
        gen, device = self._legacy_setup(config, seed, device)
        cfg, dt = config, self.dtype
        if cfg.num_vectors_a != cfg.num_vectors_v:
            raise ValueError("tmmtrvpa assumes num_vectors_a == "
                             "num_vectors_v")
        if cfg.group_encoders:
            raise ValueError("group_encoders is not supported for "
                             "tmmtrvpa; use group_encoders=False")
        self._make_inputs(gen, device)
        self._make_crossmodal_mesh(False, gen, device)
        self._make_gmus(gen, device)
        Tl, Ta, Tv = cfg.num_vectors_l, cfg.num_vectors_a, cfg.num_vectors_v
        self.transfm_a2l = SeqAdapter(Ta, Tl, dt, gen, device)
        self.transfm_v2l = SeqAdapter(Tv, Tl, dt, gen, device)
        self.transfm_l2a = SeqAdapter(Tl, Ta, dt, gen, device)
        self.transfm_l2v = SeqAdapter(Tl, Tv, dt, gen, device)
        self.gmu = GatedNModalLayer(3, cfg.hidden_sz, dt, gen, device)
        self._make_head(gen, device)

    def forward(self, txt, mask, segment, video, audio,
                output_gates: bool = False,
                dropout_seed: Optional[int] = None):
        seeds = seed_stream(dropout_seed)
        proj_l, proj_v, proj_a = self._encode_streams(txt, mask, segment,
                                                      video, audio, seeds)
        first = self._first_round(proj_l, proj_v, proj_a, seeds)
        second = self._second_round(proj_l, proj_v, proj_a, first, seeds)
        (h_v_with_as, h_a_with_vs, h_v_with_ls, h_l_with_vs, h_a_with_ls,
         h_l_with_as) = first
        last_h_l, last_h_v, last_h_a = self._targets(
            second,
            (self.transfm_a2l(h_a_with_vs), self.transfm_v2l(h_v_with_as)),
            (self.transfm_l2a(h_l_with_vs), h_v_with_ls),
            (self.transfm_l2v(h_l_with_as), h_a_with_ls), last_only=True)
        last_hs, z = self.gmu([last_h_l, last_h_v, last_h_a])
        return self._gates_or_logits(self._head(last_hs, seeds), z,
                                     output_gates)


_VARIANTS = {"original": None, "hierarchical": GatedHierarchicalLayer,
             "softmax": GatedSoftmaxLayer}


class GMUClf(_LegacyBase):
    """Trimodal GMU late fusion: BERT's pooled output and the projected
    video and audio averaged over time, one GMU (``gmu_variant``
    "original", "hierarchical" or "softmax"), one linear layer."""

    def __init__(self, config: ModelConfig, seed: int = 0, device=None,
                 gmu_variant: str = "original"):
        super().__init__()
        if gmu_variant not in _VARIANTS:
            raise ValueError(f"unknown gmu_variant {gmu_variant!r}")
        gen, device = self._legacy_setup(config, seed, device)
        cfg, dt, E = config, self.dtype, config.hidden_sz
        self.gmu_variant = gmu_variant
        self._make_inputs(gen, device, streams="va", with_pooler=True)
        widths = [cfg.bert.hidden_size, E, E]
        if gmu_variant == "original":
            self.gmu = GatedNModalLayer(3, E, dt, gen, device, widths)
        else:
            self.gmu = _VARIANTS[gmu_variant](E, dt, gen, device, widths)
        self.out_layer = linear(E, cfg.n_classes, True, "lecun", gen, device)

    def forward(self, txt, mask, segment, video, audio,
                output_gates: bool = False,
                dropout_seed: Optional[int] = None):
        cfg, dt = self.config, self.dtype
        _, pooled = self.bert(txt, mask, segment,
                              seed_stream(dropout_seed))
        x_a = (self.audio_enc(audio.to(dt)) if cfg.use_audio_encoder
               else audio.to(dt))
        xs = (pooled, self._mean_stream("v", video.to(dt)),
              self._mean_stream("a", x_a))
        last_hs, z = (self.gmu(list(xs)) if self.gmu_variant == "original"
                      else self.gmu(*xs))
        return self._gates_or_logits(self._lin(self.out_layer, last_hs), z,
                                     output_gates)


class GMUBimodalClf(_LegacyBase):
    """``gmu_bi``: text and video, a 2-input GMU, one linear layer."""

    def __init__(self, config: ModelConfig, seed: int = 0, device=None):
        super().__init__()
        gen, device = self._legacy_setup(config, seed, device)
        cfg, E = config, config.hidden_sz
        self._make_inputs(gen, device, streams="v", with_pooler=True)
        self.gmu = GatedBimodalLayer(E, self.dtype, gen, device,
                                     [cfg.bert.hidden_size, E])
        self.out_layer = linear(E, cfg.n_classes, True, "lecun", gen, device)

    def forward(self, txt, mask, segment, video,
                output_gates: bool = False,
                dropout_seed: Optional[int] = None):
        _, pooled = self.bert(txt, mask, segment,
                              seed_stream(dropout_seed))
        last_hs, z = self.gmu(pooled,
                              self._mean_stream("v", video.to(self.dtype)))
        return self._gates_or_logits(self._lin(self.out_layer, last_hs), z,
                                     output_gates)


class BertClf(_LegacyBase):
    """``bertclf`` (``bert``): the text-only baseline, BERT's pooled output
    through one linear layer ``clf``.  It has no gates: with
    ``output_gates`` it returns a (B, 0) array in the logits' dtype."""

    def __init__(self, config: ModelConfig, seed: int = 0, device=None):
        super().__init__()
        gen, device = self._legacy_setup(config, seed, device)
        cfg = config
        self._make_inputs(gen, device, streams="", with_pooler=True)
        self.clf = linear(cfg.bert.hidden_size, cfg.n_classes, True,
                          "lecun", gen, device)

    def forward(self, txt, mask, segment, output_gates: bool = False,
                dropout_seed: Optional[int] = None):
        _, pooled = self.bert(txt, mask, segment,
                              seed_stream(dropout_seed))
        logits = self._lin(self.clf, pooled)
        return self._gates_or_logits(
            logits, logits.new_zeros(logits.shape[0], 0), output_gates)
