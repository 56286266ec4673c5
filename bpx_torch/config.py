"""Typed configuration tree of the PyTorch port.

The port keeps its own copy of the JAX package's configuration dataclasses
and presets (``bpx/config.py``) so that it imports nothing of that package;
the field names, defaults and presets are identical, so a ``config.json``
snapshot written by either package loads in both (:func:`config_from_dict`).

Fields that only steer XLA compilation are accepted and inert here: the
port runs eagerly, and nothing is scanned.  They are ``scan_layers``,
``scan_encoders`` and ``scan_unroll``.  ``remat``, ``remat_policy``,
``remat_bert`` and ``remat_policy_bert`` recompute layers in the backward as
in the JAX package (``models/bpmult.py``).
``attention_impl`` (and ``bert_attention_impl`` for BERT, None inheriting
it) chooses the attention as in the JAX package: ``"pallas"`` the
hand-written flash kernels, anything else the plain einsum attention.
``hybrid`` adds the early-fusion branch and ``group_encoders`` stacks the
crossmodal encoders in pairs (``models/bpmult.py``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class BertConfig:
    """BERT text encoder; defaults match ``bert-base-uncased``."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # DistilBERT-style variant: no token-type embeddings.
    use_token_type: bool = True
    # FFN activation: "erf" is the exact GELU of HF BERT; "tanh" is the
    # original google-research/bert approximation (max abs deviation ~1e-3).
    gelu: str = "erf"

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def distil() -> "BertConfig":
        return BertConfig(num_layers=6, use_token_type=False)

    @staticmethod
    def large() -> "BertConfig":
        return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                          intermediate_size=4096)

    @staticmethod
    def tiny(vocab_size: int = 1024) -> "BertConfig":
        """A small config for tests / synthetic runs (no pretrained weights)."""
        return BertConfig(vocab_size=vocab_size, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128,
                          max_position_embeddings=512)


@dataclass(frozen=True)
class ModelConfig:
    """BPMulT model hyper-parameters (names follow the reference CLI flags)."""

    model: str = "mmtrvapt"          # "mmtrvapt" (4-input) | "mmtrvat" (3-input)
    n_classes: int = 13

    # Per-modality raw feature dims.
    orig_d_l: int = 768
    orig_d_v: int = 4096
    orig_d_a: int = 96
    orig_d_p: int = 4096

    hidden_sz: int = 768
    num_heads: int = 8
    layers: int = 5                  # depth of every crossmodal encoder

    # Static per-modality stream lengths after padding.
    num_vectors_l: int = 512
    num_vectors_a: int = 200
    num_vectors_v: int = 200

    # Which target modalities participate (True == active).
    lonly: bool = True
    vonly: bool = True
    aonly: bool = True

    attn_mask: bool = True           # rectangular offset future-mask
    hybrid: bool = False             # early-fusion branch
    reduced_dim: int = 32            # hybrid low-rank dim

    # Dropouts (inactive in the serving forward).
    attn_dropout: float = 0.1
    attn_dropout_v: float = 0.0
    attn_dropout_a: float = 0.0
    relu_dropout: float = 0.1
    res_dropout: float = 0.1
    out_dropout: float = 0.0
    embed_dropout: float = 0.25

    # Modality-encoder selection.
    use_audio_encoder: bool = True   # mmtrvapt Moviescope path; False == raw audio
    use_poster: bool = True          # 4th input (mmtrvapt only)
    audio_encoder: str = "moviescope"  # moviescope | cmumosei | cmumosi | none

    bert: BertConfig = field(default_factory=BertConfig)
    # "pretrained" loads HF weights from bert_weights_path; "random"
    # initialises from scratch (tests / no-egress environments).
    bert_init: str = "random"
    bert_weights_path: Optional[str] = None
    freeze_bert: bool = False

    # dtype policy: params fp32, activations in compute_dtype, softmax and
    # LayerNorm statistics fp32.
    compute_dtype: str = "bfloat16"
    # "pallas": the flash kernels; anything else: the einsum attention.
    attention_impl: str = "xla"
    bert_attention_impl: Optional[str] = None     # None: attention_impl
    # Final fusion: "gmu" (reference default) or "mag" (mmtrvat only).
    fusion: str = "gmu"
    # Recompute per layer in the backward (models/bpmult.py); the scan
    # fields are inert in the port (see the module docstring).
    scan_layers: bool = False
    remat: bool = False
    remat_policy: Optional[str] = None
    remat_bert: Optional[bool] = None
    remat_policy_bert: Optional[str] = None
    scan_encoders: Optional[bool] = None
    scan_unroll: int = 1
    # Pairs of same-shape encoders stacked into one call; changes the
    # parameter tree layout (a leading pair axis of 2).
    group_encoders: bool = False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def seq_lens(self) -> Tuple[int, int, int]:
        return (self.num_vectors_l, self.num_vectors_v, self.num_vectors_a)


@dataclass(frozen=True)
class DataConfig:
    """Host-side pipeline config."""

    task: str = "moviescope"   # moviescope|mmimdb|iemocap|cmu-mosei|cmu-mosi|counseling|synthetic
    task_type: str = "multilabel"    # multilabel | classification
    data_path: str = "/"
    bert_model: str = "bert-base-uncased"
    bert_vocab_path: Optional[str] = None
    max_seq_len: int = 512
    batch_sz: int = 128
    n_workers: int = 4
    visual: str = "both"             # poster | video | both | none
    drop_img_percent: float = 0.0
    glove_path: Optional[str] = None
    # Static raw lengths fed to collate (audio frames pre-encoder, video frames).
    audio_raw_len: int = 928
    video_len: int = 200
    feature_cache: bool = True
    # Synthetic-data knobs (tests / benches).
    synthetic_len: int = 256
    synthetic_seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """The ``(data, fsdp, tensor)`` mesh a run of more than one rank trains
    on (``bpx_torch/parallel/mesh.py::make_mesh``; the CLI's
    ``--mesh_data/--mesh_fsdp/--mesh_tensor``); ignored on one rank, as
    the JAX package ignores it on one device."""

    data: int = -1                   # -1 == all remaining devices
    fsdp: int = 1
    tensor: int = 1
    axis_names: Tuple[str, str, str] = ("data", "fsdp", "tensor")


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop config."""

    name: str = "nameless"
    savedir: str = "./runs"
    seed: int = 1234
    from_seed: int = 1
    to_seed: int = 5
    inverse_seed: bool = False

    lr: float = 1e-3
    optimizer: str = "adam"          # adam | radam | plain_radam
    lr_factor: float = 0.5           # ReduceLROnPlateau factor
    lr_patience: int = 2
    max_epochs: int = 100
    patience: int = 10               # early stopping
    gradient_accumulation_steps: int = 32
    weight_classes: bool = True      # inverse-frequency class weights
    just_test: bool = False
    output_gates: bool = False       # GMU gate interpretability channel
    log_every: int = 50
    checkpoint_keep: int = 2
    profile_dir: Optional[str] = None
    rng_impl: str = "rbg"
    accum_dtype: Optional[str] = None
    accum_unroll: bool = False
    accum_scan_unroll: int = 1

    mesh: MeshConfig = field(default_factory=MeshConfig)


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Canonical per-task presets (the same values as the JAX package's).
# ---------------------------------------------------------------------------

def _moviescope() -> ExperimentConfig:
    """Moviescope 4-modal: video VGG16 frames + mel-spectrogram audio + plot
    text + poster."""
    return ExperimentConfig(
        model=ModelConfig(
            model="mmtrvapt", n_classes=13,
            orig_d_l=768, orig_d_v=4096, orig_d_a=96, orig_d_p=4096,
            hidden_sz=768, num_heads=8, layers=4,
            num_vectors_l=512, num_vectors_a=200, num_vectors_v=200,
            use_audio_encoder=True, use_poster=True,
            scan_layers=True, remat=False,
            attention_impl="pallas",
            scan_unroll=8,
            scan_encoders=False,
            bert=BertConfig(gelu="tanh"),
        ),
        data=DataConfig(task="moviescope", task_type="multilabel",
                        audio_raw_len=928, video_len=200),
    )


def _mmimdb() -> ExperimentConfig:
    """MM-IMDb: plot text + GloVe 'video' stream + BoW-as-audio + VGG poster."""
    return ExperimentConfig(
        model=ModelConfig(
            model="mmtrvapt", n_classes=23,
            orig_d_l=768, orig_d_v=300, orig_d_a=1, orig_d_p=4096,
            hidden_sz=768, num_heads=6, layers=4,
            num_vectors_l=512, num_vectors_a=512, num_vectors_v=512,
            use_audio_encoder=False, use_poster=True,
            scan_layers=True, remat=True, attention_impl="pallas",
            remat_policy="save_attn", bert=BertConfig(gelu="tanh"),
        ),
        data=DataConfig(task="mmimdb", task_type="multilabel",
                        audio_raw_len=512, video_len=512),
    )


def _iemocap() -> ExperimentConfig:
    """IEMOCAP aligned trimodal."""
    return ExperimentConfig(
        model=ModelConfig(
            model="mmtrvat", n_classes=8,
            orig_d_l=768, orig_d_v=35, orig_d_a=74,
            hidden_sz=300, num_heads=12, layers=8,
            num_vectors_l=512, num_vectors_a=512, num_vectors_v=512,
            use_audio_encoder=False, use_poster=False,
            scan_layers=True, remat=True, attention_impl="pallas",
            bert=BertConfig(gelu="tanh"),
        ),
        data=DataConfig(task="iemocap", task_type="multilabel",
                        audio_raw_len=512, video_len=512),
    )


def _cmu_mosei() -> ExperimentConfig:
    """CMU-MOSEI unaligned trimodal."""
    return ExperimentConfig(
        model=ModelConfig(
            model="mmtrvat", n_classes=6,
            orig_d_l=768, orig_d_v=35, orig_d_a=74,
            hidden_sz=300, num_heads=10, layers=8,
            num_vectors_l=512, num_vectors_a=512, num_vectors_v=512,
            use_audio_encoder=False, use_poster=False,
            scan_layers=True, remat=True, attention_impl="pallas",
            bert=BertConfig(gelu="tanh"),
        ),
        data=DataConfig(task="cmu-mosei", task_type="multilabel",
                        audio_raw_len=512, video_len=512),
    )


def _counseling() -> ExperimentConfig:
    """Counseling: glove 'video' stream + fasttext-as-audio."""
    return ExperimentConfig(
        model=ModelConfig(
            model="mmtrvat", n_classes=2,
            orig_d_l=768, orig_d_v=300, orig_d_a=300,
            hidden_sz=300, num_heads=10, layers=5,
            num_vectors_l=512, num_vectors_a=512, num_vectors_v=512,
            use_audio_encoder=False, use_poster=False,
            scan_layers=True, remat=True, attention_impl="pallas",
        ),
        data=DataConfig(task="counseling", task_type="multilabel",
                        audio_raw_len=512, video_len=512),
    )


def _cmu_mosi() -> ExperimentConfig:
    """CMU-MOSI regression (L1 loss)."""
    return ExperimentConfig(
        model=ModelConfig(
            model="mmtrvat", n_classes=1,
            orig_d_l=768, orig_d_v=20, orig_d_a=5,
            hidden_sz=300, num_heads=10, layers=5,
            num_vectors_l=512, num_vectors_a=512, num_vectors_v=512,
            use_audio_encoder=False, use_poster=False,
            scan_layers=True, remat=True, attention_impl="pallas",
        ),
        data=DataConfig(task="cmu-mosi", task_type="classification",
                        audio_raw_len=512, video_len=512),
    )


def _stress() -> ExperimentConfig:
    """Scaled stress config: 12 layers, hidden 1024, batch 64, long
    unaligned sequences, bert-large text encoder."""
    return ExperimentConfig(
        model=ModelConfig(
            model="mmtrvapt", n_classes=13,
            orig_d_l=1024, orig_d_v=4096, orig_d_a=96, orig_d_p=4096,
            hidden_sz=1024, num_heads=16, layers=12,
            num_vectors_l=1024, num_vectors_a=768, num_vectors_v=768,
            use_audio_encoder=True, use_poster=True,
            bert=dataclasses.replace(BertConfig.large(), gelu="tanh"),
            attention_impl="pallas",
            scan_layers=True, remat=True,
        ),
        data=DataConfig(task="moviescope", task_type="multilabel",
                        batch_sz=64, audio_raw_len=2176, video_len=768),
    )


def _synthetic_tiny() -> ExperimentConfig:
    """CPU-runnable smoke config: tiny BERT, tiny dims, synthetic data."""
    return ExperimentConfig(
        model=ModelConfig(
            model="mmtrvapt", n_classes=5,
            orig_d_l=64, orig_d_v=48, orig_d_a=96, orig_d_p=40,
            hidden_sz=64, num_heads=4, layers=2,
            num_vectors_l=32, num_vectors_a=16, num_vectors_v=16,
            use_audio_encoder=True, use_poster=True,
            bert=BertConfig.tiny(), compute_dtype="float32",
        ),
        data=DataConfig(task="synthetic", task_type="multilabel",
                        batch_sz=8, max_seq_len=32,
                        audio_raw_len=576, video_len=16, synthetic_len=64),
        train=TrainConfig(lr=1e-3, max_epochs=2,
                          gradient_accumulation_steps=2),
    )


PRESETS: Dict[str, Any] = {
    "moviescope": _moviescope,
    "mmimdb": _mmimdb,
    "iemocap": _iemocap,
    "cmu-mosei": _cmu_mosei,
    "cmu-mosi": _cmu_mosi,
    "counseling": _counseling,
    "stress": _stress,
    "synthetic-tiny": _synthetic_tiny,
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]()


def config_from_dict(d: Dict) -> ExperimentConfig:
    """Rebuild the typed config tree from a ``config.json`` snapshot
    (``dataclasses.asdict`` of an :class:`ExperimentConfig`).

    Tuples come back as lists from JSON and are re-tupled where the field is
    typed as one; unknown keys are ignored so snapshots stay loadable across
    field additions.
    """
    def build(cls, sub: Dict):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in sub.items() if k in names})

    model_d = dict(d.get("model", {}))
    model_d["bert"] = build(BertConfig, model_d.get("bert", {}))
    train_d = dict(d.get("train", {}))
    mesh_d = dict(train_d.get("mesh", {}))
    if "axis_names" in mesh_d:
        mesh_d["axis_names"] = tuple(mesh_d["axis_names"])
    train_d["mesh"] = build(MeshConfig, mesh_d)
    return ExperimentConfig(model=build(ModelConfig, model_d),
                            data=build(DataConfig, d.get("data", {})),
                            train=build(TrainConfig, train_d))
