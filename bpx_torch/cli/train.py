"""Training CLI of the PyTorch port (counterpart: ``bpx/cli/train.py``),
with the same flags and defaults, plus ``--device``.

Usage mirrors the reference README commands, e.g.::

    python -m bpx_torch.cli.train --model mmtrvapt --task moviescope \\
        --data_path /data --hidden_sz 768 --num_heads 8 --layers 4 \\
        --orig_d_v 4096 --orig_d_a 96 --batch_sz 8 \\
        --gradient_accumulation_steps 16 --attention_impl pallas \\
        --savedir runs/

Notes:
* ``--vonly/--lonly/--aonly`` and ``--attn_mask`` are ``store_false`` flags
  as in the reference (passing them *disables* the feature);
* flags of the reference that no registered model reads are accepted and
  unused;
* ``--train_type cross`` runs the 10-fold cross-validation partitions;
* ``--device`` (default "cuda") places the model; "cpu" runs the plain
  PyTorch versions of the kernels on the host.  Models and options not
  ported yet raise (``get_model``, ``make_optimizer``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from bpx_torch.config import (BertConfig, DataConfig, ExperimentConfig,
                              MeshConfig, ModelConfig, TrainConfig,
                              get_preset)


def get_args(parser: argparse.ArgumentParser):
    # training / data flags (ref: train.py:33-74)
    parser.add_argument("--batch_sz", type=int, default=128)
    parser.add_argument("--bert_model", type=str, default="bert-base-uncased",
                        choices=["bert-base-uncased", "bert-large-uncased",
                                 "distilbert-base-uncased"])
    parser.add_argument("--bert_vocab", type=str, default=None,
                        help="local vocab.txt for the WordPiece tokenizer")
    parser.add_argument("--bert_weights", type=str, default=None,
                        help="local HF torch checkpoint for BERT init")
    parser.add_argument("--bert_gelu", type=str, default=None,
                        choices=["erf", "tanh"],
                        help="BERT FFN GELU form: erf = exact HF/torch "
                             "numerics; tanh = original-BERT approximation "
                             "(default: the BertConfig/preset choice)")
    parser.add_argument("--data_path", type=str, default="/")
    parser.add_argument("--dropout", type=float, default=0.1)
    parser.add_argument("--freeze_txt", type=int, default=0)
    parser.add_argument("--glove_path", type=str, default=None)
    parser.add_argument("--gradient_accumulation_steps", type=int, default=32)
    parser.add_argument("--hidden_sz", type=int, default=768)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--lr_factor", type=float, default=0.5)
    parser.add_argument("--lr_patience", type=int, default=2)
    parser.add_argument("--max_epochs", type=int, default=100)
    parser.add_argument("--max_seq_len", type=int, default=512)
    parser.add_argument("--model", type=str, default="mmtrvapt",
                        choices=["mmtrvat", "mmtrvapt",
                                 # notebook-era models (SURVEY.md C30)
                                 "mmtrvpa", "tmmtrvpa", "gmu", "gmu_bi",
                                 "gmu_hier", "gmu_softmax",
                                 # text-only baseline (notebook 1 cell 54
                                 # name "bert"; "bertclf" is an alias)
                                 "bert", "bertclf"])
    parser.add_argument("--n_workers", type=int, default=4)
    parser.add_argument("--feature_cache", type=int, default=1,
                        help="precollated memmap cache next to the jsonl "
                             "(bpx_torch.data.cache); 0 = re-read per-sample "
                             "feature files every epoch (e.g. read-only "
                             "data dirs)")
    parser.add_argument("--name", type=str, default="nameless")
    parser.add_argument("--visual", type=str, default="both",
                        choices=["poster", "video", "both", "none"])
    parser.add_argument("--patience", type=int, default=10)
    parser.add_argument("--savedir", type=str, default="./runs")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--task", type=str, default="moviescope",
                        choices=["iemocap", "mmimdb", "moviescope",
                                 "cmu-mosei", "cmu-mosi", "counseling",
                                 "synthetic"])
    parser.add_argument("--task_type", type=str, default="multilabel",
                        choices=["multilabel", "classification"])
    parser.add_argument("--weight_classes", type=int, default=1)
    parser.add_argument("--output_gates", action="store_true",
                        help="store GMU gates of the test set")
    parser.add_argument("--train_type", type=str, default="split",
                        choices=["split", "cross"])
    parser.add_argument("--just_test", action="store_true")
    parser.add_argument("--from_seed", type=int, default=1)
    parser.add_argument("--to_seed", type=int, default=5)
    parser.add_argument("--inverse_seed", action="store_true")
    parser.add_argument("--hybrid", action="store_true")

    # MMTransformer parameters (ref: train.py:75-97)
    parser.add_argument("--vonly", action="store_false",
                        help="passing this DISABLES crossmodal fusion into v "
                             "(reference-compatible inversion)")
    parser.add_argument("--lonly", action="store_false")
    parser.add_argument("--aonly", action="store_false")
    parser.add_argument("--orig_d_v", type=int, default=2048)
    parser.add_argument("--orig_d_l", type=int, default=768)
    parser.add_argument("--orig_d_a", type=int, default=96)
    parser.add_argument("--orig_d_p", type=int, default=4096)
    parser.add_argument("--attn_dropout", type=float, default=0.1)
    parser.add_argument("--attn_dropout_v", type=float, default=0.0)
    parser.add_argument("--attn_dropout_a", type=float, default=0.0)
    parser.add_argument("--relu_dropout", type=float, default=0.1)
    parser.add_argument("--embed_dropout", type=float, default=0.25)
    parser.add_argument("--res_dropout", type=float, default=0.1)
    parser.add_argument("--out_dropout", type=float, default=0.0)
    parser.add_argument("--nlevels", type=int, default=5)
    parser.add_argument("--layers", type=int, default=5)
    parser.add_argument("--num_heads", type=int, default=5)
    parser.add_argument("--attn_mask", action="store_false",
                        help="passing this DISABLES the offset future mask")

    # extensions of the JAX package
    parser.add_argument("--preset", type=str, default=None,
                        help="start from a named preset "
                             "(moviescope/mmimdb/iemocap/...)")
    parser.add_argument("--num_vectors_l", type=int, default=512)
    parser.add_argument("--num_vectors_a", type=int, default=200)
    parser.add_argument("--num_vectors_v", type=int, default=200)
    parser.add_argument("--audio_raw_len", type=int, default=928)
    parser.add_argument("--video_len", type=int, default=200)
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--attention_impl", type=str, default="xla",
                        choices=["xla", "pallas"])
    parser.add_argument("--fusion", type=str, default="gmu",
                        choices=["gmu", "mag"],
                        help="final fusion on mmtrvat: GMU (reference "
                             "default) or MAG (ref: mmtr.py:10,355-358)")
    parser.add_argument("--use_audio_encoder", type=str, default="auto",
                        choices=["auto", "1", "0"],
                        help="conv audio encoder; auto = moviescope+mmtrvapt "
                             "only (the reference's hard-coded rule, "
                             "mmtr.py:306-307)")
    parser.add_argument("--mesh_data", type=int, default=-1)
    parser.add_argument("--mesh_fsdp", type=int, default=1)
    parser.add_argument("--mesh_tensor", type=int, default=1)
    parser.add_argument("--profile_dir", type=str, default=None)
    parser.add_argument("--accum_dtype", type=str, default=None,
                        choices=["bfloat16"],
                        help="gradient-accumulation carry dtype (default "
                             "fp32; bfloat16 is not ported and raises)")
    parser.add_argument("--accum_scan_unroll", type=int, default=1,
                        help="accepted for the JAX package's CLI; inert "
                             "(an XLA program knob)")
    parser.add_argument("--scan_layers", action="store_true",
                        help="accepted for the JAX package's CLI; inert")
    parser.add_argument("--remat", action="store_true",
                        help="accepted for the JAX package's CLI; inert "
                             "(recompute is not ported yet)")
    parser.add_argument("--scan_unroll", type=int, default=1,
                        help="accepted for the JAX package's CLI; inert")
    parser.add_argument("--optimizer", type=str, default="adam",
                        choices=["adam", "adamw", "radam", "plain_radam"])
    parser.add_argument("--device", type=str, default="cuda",
                        help="device of the model and the kernels; \"cpu\" "
                             "runs the plain PyTorch versions on the host")

    # Reference flags accepted for drop-in compatibility; unused by the
    # registered BPMulT models in the reference too (ref: train.py:36-68 —
    # they belong to the superseded MMBT-era models or are dead, e.g.
    # --warmup is never consumed, train.py:64).
    for flag, default in [("--embed_sz", 300), ("--freeze_img", 0),
                          ("--img_hidden_sz", 2048), ("--include_bn", 1),
                          ("--num_image_embeds", 1), ("--num_images", 8),
                          ("--chunk_size", 100),
                          ("--v_len", 3), ("--l_len", 512), ("--a_len", 3)]:
        parser.add_argument(flag, type=int, default=default,
                            help="accepted for reference CLI compatibility")
    parser.add_argument("--warmup", type=float, default=0.1,
                        help="accepted for reference CLI compatibility "
                             "(dead flag in the reference, train.py:64)")
    parser.add_argument("--img_embed_pool_type", type=str, default="avg",
                        choices=["max", "avg"])
    parser.add_argument("--pooling", type=str, default="cls",
                        choices=["cls", "att", "cls_att", "vert_att"])
    parser.add_argument("--drop_img_percent", type=float, default=0.0)


def args_to_config(args: argparse.Namespace) -> ExperimentConfig:
    if args.preset:
        exp = get_preset(args.preset)
    else:
        exp = ExperimentConfig()
    if args.task == "synthetic":
        # tiny BERT sized to the text feature dim (no pretrained weights)
        heads = max(1, args.orig_d_l // 16)
        bert = BertConfig(vocab_size=1024, hidden_size=args.orig_d_l,
                          num_layers=2, num_heads=heads,
                          intermediate_size=2 * args.orig_d_l,
                          max_position_embeddings=max(512, args.max_seq_len))
    elif args.bert_model == "bert-large-uncased":
        bert = BertConfig.large()
    elif args.bert_model == "distilbert-base-uncased":
        bert = BertConfig.distil()
    else:
        bert = BertConfig.base()
    if args.bert_gelu:
        bert = dataclasses.replace(bert, gelu=args.bert_gelu)

    if args.use_audio_encoder == "auto":
        use_audio_encoder = (args.task == "moviescope"
                             and args.model == "mmtrvapt")
    else:
        use_audio_encoder = args.use_audio_encoder == "1"
    use_poster = args.model == "mmtrvapt"
    model = ModelConfig(
        model=args.model, n_classes=exp.model.n_classes,
        orig_d_l=args.orig_d_l, orig_d_v=args.orig_d_v,
        orig_d_a=args.orig_d_a, orig_d_p=args.orig_d_p,
        hidden_sz=args.hidden_sz, num_heads=args.num_heads,
        layers=args.layers,
        num_vectors_l=args.num_vectors_l, num_vectors_a=args.num_vectors_a,
        num_vectors_v=args.num_vectors_v,
        lonly=args.lonly, vonly=args.vonly, aonly=args.aonly,
        attn_mask=args.attn_mask, hybrid=args.hybrid,
        attn_dropout=args.attn_dropout, attn_dropout_v=args.attn_dropout_v,
        attn_dropout_a=args.attn_dropout_a, relu_dropout=args.relu_dropout,
        res_dropout=args.res_dropout, out_dropout=args.out_dropout,
        embed_dropout=args.embed_dropout,
        use_audio_encoder=use_audio_encoder, use_poster=use_poster,
        bert=bert,
        bert_init="pretrained" if args.bert_weights else "random",
        bert_weights_path=args.bert_weights,
        freeze_bert=args.freeze_txt > 0,
        compute_dtype=args.compute_dtype,
        attention_impl=args.attention_impl,
        fusion=args.fusion,
        scan_layers=args.scan_layers, remat=args.remat,
        scan_unroll=args.scan_unroll)
    data = DataConfig(
        task=args.task, task_type=args.task_type, data_path=args.data_path,
        bert_model=args.bert_model, bert_vocab_path=args.bert_vocab,
        max_seq_len=args.max_seq_len, batch_sz=args.batch_sz,
        n_workers=args.n_workers, visual=args.visual,
        glove_path=args.glove_path, audio_raw_len=args.audio_raw_len,
        video_len=args.video_len, feature_cache=bool(args.feature_cache))
    train_cfg = TrainConfig(
        name=args.name, savedir=args.savedir, seed=args.seed,
        optimizer=args.optimizer,
        from_seed=args.from_seed, to_seed=args.to_seed,
        inverse_seed=args.inverse_seed, lr=args.lr,
        lr_factor=args.lr_factor, lr_patience=args.lr_patience,
        max_epochs=args.max_epochs, patience=args.patience,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        weight_classes=bool(args.weight_classes),
        just_test=args.just_test, output_gates=args.output_gates,
        profile_dir=args.profile_dir, accum_dtype=args.accum_dtype,
        accum_scan_unroll=args.accum_scan_unroll,
        mesh=MeshConfig(data=args.mesh_data, fsdp=args.mesh_fsdp,
                        tensor=args.mesh_tensor))
    return ExperimentConfig(model=model, data=data, train=train_cfg)


def cli_main(argv=None):
    from bpx_torch.train.loop import seed_sweep, test, train

    parser = argparse.ArgumentParser(
        description="Train BPMulT (PyTorch port)")
    get_args(parser)
    args = parser.parse_args(argv)
    exp = args_to_config(args)

    if args.train_type == "split":
        return seed_sweep(exp, device=args.device)
    # cross-validation: the reference's helpers.py partition arithmetic
    task_dir = os.path.join(exp.data.data_path, exp.data.task)
    with open(os.path.join(task_dir, "train.jsonl")) as f:
        data_all = [json.loads(line) for line in f]
    results = {}
    for k in range(10):
        run = exp.replace(train=dataclasses.replace(
            exp.train, name=f"{exp.train.name}_fold{k}"))
        if not args.just_test:
            train(run, data_all=data_all, partition_index=k,
                  device=args.device)
        results[k] = test(run, data_all=data_all, partition_index=k,
                          device=args.device)
    return results


if __name__ == "__main__":
    cli_main()
