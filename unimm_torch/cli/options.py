"""Command-line flags: the port's copy of the JAX package's
``cli/options.py``, the whole parser: the reference's single-dash argparse
surface (the reference's options.py:7-105) preserved verbatim, plus the
JAX package's additions (vocab path, mesh shape, dtype, chunk size). An
argv parses to the dict the JAX package's parser gives it
(tests/test_torch_cli.py); no flag is added or dropped.

Flags kept for CLI compatibility but without effect are accepted and noted
in their help strings (visdom server flags). The world is joined through
``-coordinator_address host:port -num_processes N -process_id r``, one
process per card, and arranged as dp x ``-mesh_mp`` (``parallel/dist.py``);
``check_world`` refuses flags that name no such world: ``-n_gpus`` other
than 0 or the world's size (the JAX package's ``-n_gpus`` may pick some of
one process's devices; a port process drives one card), a ``-mesh_mp``
that does not divide the world's size (``make_mesh``'s assert), and
``-mesh_mp`` above 1 without a world (the JAX package shards one
process's devices; the port's mp axis is mp processes).
"""

from __future__ import annotations

import argparse
import os
import random
from time import gmtime, strftime


def read_command_line(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="UniMM-UL visual dialog (PyTorch / CUDA)")

    # ---- data ----
    parser.add_argument('-visdial_processed_train',
                        default='data/visdial/visdial_1.0_train_processed.json')
    parser.add_argument('-visdial_processed_val',
                        default='data/visdial/visdial_1.0_val_processed.json')
    parser.add_argument('-visdial_processed_test',
                        default='data/visdial/visdial_1.0_test_processed.json')
    parser.add_argument('-visdial_image_feats',
                        default='data/visdial/visdial_img_feat.lmdb')
    parser.add_argument('-visdial_processed_train_dense',
                        default='data/visdial/visdial_1.0_train_dense_processed.json')
    parser.add_argument('-visdial_processed_train_dense_annotations',
                        default='data/visdial/visdial_1.0_train_dense_annotations_processed.json')
    parser.add_argument('-visdial_processed_val_dense_annotations',
                        default='data/visdial/visdial_1.0_val_dense_annotations_processed.json')
    parser.add_argument('-start_path', default='',
                        help='checkpoint to start from (.ckpt torch format or orbax dir)')
    parser.add_argument('-model_config',
                        default='config/bert_base_6layer_6conect.json')
    parser.add_argument('-model_paths', default='',
                        help='comma-separated checkpoints for ensemble eval '
                             '(replaces the reference\'s hard-coded paths)')

    # ---- logging (visdom flags accepted for compatibility; logging goes to
    # stdout + CSV/TensorBoard) ----
    parser.add_argument('-enable_visdom', type=int, default=0)
    parser.add_argument('-visdom_env', type=str, default='pretrain')
    parser.add_argument('-visdom_server', type=str, default='http://127.0.0.1')
    parser.add_argument('-visdom_server_port', type=int, default=8097)

    # ---- optimization / environment ----
    parser.add_argument('-num_workers', default=8, type=int)
    parser.add_argument('-batch_size', default=80, type=int)
    parser.add_argument('-num_epochs', default=400, type=int)
    parser.add_argument('-batch_multiply', default=1, type=int)
    parser.add_argument('-lr', default=2e-5, type=float)
    parser.add_argument('-image_lr', default=2e-5, type=float)
    parser.add_argument('-overfit', action='store_true')
    parser.add_argument('-continue', action='store_true')
    parser.add_argument('-num_train_samples', default=0, type=int)
    parser.add_argument('-num_val_samples', default=0, type=int)
    parser.add_argument('-num_options', default=100, type=int)
    parser.add_argument('-n_gpus', default=0, type=int,
                        help='number of mesh devices (reference semantics: '
                             'devices running the job); 0 = all local devices')
    parser.add_argument('-sequences_per_image', default=8, type=int)
    parser.add_argument('-visdial_tot_rounds', default=11, type=int)
    parser.add_argument('-max_seq_len', default=256, type=int)
    parser.add_argument('-num_negative_samples', default=1, type=int)
    parser.add_argument('-neg_token_weight', default=1, type=int)
    parser.add_argument('-lm_loss_coeff', default=1, type=float)
    parser.add_argument('-nsp_loss_coeff', default=1, type=float)
    parser.add_argument('-img_loss_coeff', default=1, type=float)
    parser.add_argument('-mask_prob', default=0.15, type=float)
    parser.add_argument('-train_dis_rate', default=0.5, type=float)
    parser.add_argument('-val_dis', default=1, type=int)
    parser.add_argument('-test_dis', default=1, type=int)
    parser.add_argument('-save_path', default='checkpoints/')
    parser.add_argument('-save_name', default='')

    # ---- the JAX package's additions ----
    parser.add_argument('-vocab_path', default='config/vocab.txt',
                        help='WordPiece vocab file (bert-base-uncased layout)')
    parser.add_argument('-mesh_mp', default=1, type=int,
                        help='tensor-parallel mesh axis size')
    parser.add_argument('-eval_chunk', default=250, type=int,
                        help='sequences per eval forward chunk (the flat '
                             'scorer)')
    parser.add_argument('-dtype', default='bfloat16',
                        choices=['bfloat16', 'float32'])
    parser.add_argument('-seed', default=0, type=int)
    parser.add_argument('-save_every_epochs', default=1, type=int)
    parser.add_argument('-eval_every_epochs', default=10, type=int)
    parser.add_argument('-language_weights',
                        default='config/language_weights.json')
    parser.add_argument('-coordinator_address', default='',
                        help='multi-process: the process group '
                             'coordinator (host:port)')
    parser.add_argument('-num_processes', default=0, type=int)
    parser.add_argument('-process_id', default=-1, type=int)
    parser.add_argument('-remat', default=1, type=int,
                        help='rematerialise encoder layers in backward')
    parser.add_argument('-profile_dir', default='',
                        help='write a profiler trace of steps 10-14 here '
                             '(training)')
    parser.add_argument('-length_buckets', default=8, type=int,
                        help='sort accumulation microbatches by attended '
                             'extent and run each at the smallest covering '
                             'multiple of max_seq_len/N (0 = off; 1 = '
                             'quarter buckets; N>=2 = N buckets). '
                             'batch_multiply > 1; exact (group loss '
                             'normalisers). Eval always buckets (exact); '
                             'this flag covers training.')
    parser.add_argument('-adam_mu_dtype', default='',
                        choices=['', 'bfloat16', 'float32'],
                        help='dtype of the first Adam moment; bfloat16 '
                             'halves mu HBM traffic in the optimizer update '
                             '(default: float32, exact reference parity)')
    parser.add_argument('-fused_adamw', default=0, type=int,
                        help='1 = fused per-leaf AdamW update kernel '
                             '(ops/adamw.py): numerically identical to the '
                             'default grouped AdamW. mu stays fp32 '
                             '(-adam_mu_dtype ignored under 1)')
    parser.add_argument('-label_overflow_policy', default='dense',
                        choices=['dense', 'error', 'allow'],
                        help='gathered-MLM label-budget overflow handling: '
                             'route the batch through the exact dense-logits '
                             'step, raise, or allow silent truncation '
                             '(telemetry counts it either way)')
    parser.add_argument('-gen_prefix', default=1, type=int,
                        help='generative val scoring via the prefix-cache '
                             'scorer (eval/prefix.py: one shared-context '
                             'prefill per slate + thin answer-rows passes; '
                             'exact to float rounding). 0 = always use the '
                             'flat full-forward path')
    parser.add_argument('-prefix_group', default=40, type=int,
                        help='slates per prefix-scorer dispatch group; the '
                             'default 40 = one dispatch per -eval_coalesce'
                             '-2 pair of 20-slate batches')
    parser.add_argument('-prefix_packed', default=1, type=int,
                        help='prefix-scorer answer rows packed contiguously '
                             'per option (eval/prefix.py pack_option_rows: '
                             'row FLOPs track sum(2*ans_len) instead of '
                             'O*W). 0 = the W-padded layout')
    parser.add_argument('-prefix_rowblock', default=0, type=int,
                        help='packed answer-row bin size (rows per answer-'
                             'block row block). 0 = adaptive per context '
                             'bucket (64 at Lcb<=192, else 256); an option '
                             'that needs more rows takes the W-padded '
                             'layout')
    parser.add_argument('-eval_pipeline', default=1, type=int,
                        help='val batches kept in flight by the serving '
                             'loop (evaluate_split pipeline_depth)')
    parser.add_argument('-eval_coalesce', default=2, type=int,
                        help='consecutive val batches merged into ONE '
                             'scoring dispatch (exact; the default 2 with '
                             '-prefix_group 40 = one dispatch per pair). '
                             'Pair with -prefix_group = slates per '
                             'coalesced batch')
    parser.add_argument('-eval_data_sharded', default=0, type=int,
                        help='multi-process eval mode: 1 = each process '
                             'scores a DISJOINT shard of the val split on '
                             'its local devices and the metrics are '
                             'allgather-merged (throughput scales with '
                             'hosts; non-divisible tails are padded+masked '
                             'so every dialog is scored). 0 (default) = '
                             'every process iterates the full split with '
                             'batches sharded over the global mesh')
    parser.add_argument('-auto_resume', action='store_true',
                        help='preemption-safe restart (train + '
                             'dense_finetune): if this '
                             "run's save_path already holds a native "
                             'checkpoint, resume from its latest step '
                             '(weights + AdamW moments + schedule position) '
                             'and complete the ORIGINAL -num_epochs budget '
                             '(idempotent: relaunching a finished run is a '
                             'no-op, unlike -continue which trains '
                             'num_epochs more); otherwise start fresh, '
                             'honoring -start_path as the warm-start. '
                             'Requires -save_name so a relaunch resolves '
                             'the same save_path. The reference has no '
                             'auto-resume (recovery is manual -continue)')
    parser.add_argument('-attention_impl', default='pallas_block',
                        choices=['xla', 'pallas', 'pallas_block'],
                        help='text self-attention backend: the plain bias '
                             'path ("xla", no kernel), the per-head kernel '
                             'with in-kernel mask generation ("pallas": B6), '
                             'or the whole-sub-block kernels '
                             '("pallas_block": K1-K3, B4; the names are the '
                             'JAX package\'s)')

    parsed = vars(parser.parse_args(args=argv))
    if parsed['save_name']:
        parsed['save_path'] = os.path.join(parsed['save_path'],
                                           parsed['save_name'])
    else:
        stamp = strftime('%d-%b-%y-%X-%a', gmtime())
        parsed['save_path'] = os.path.join(
            parsed['save_path'],
            stamp + '_{:0>6d}{}'.format(random.randint(0, int(10e6)),
                                        parsed['visdom_env']))
    assert parsed['sequences_per_image'] <= 100
    assert parsed['visdial_tot_rounds'] <= 11
    if parsed['prefix_group'] < 1:
        raise SystemExit('-prefix_group must be >= 1 (slates per prefix-'
                         'scorer dispatch group)')
    if parsed['auto_resume'] and not parsed['save_name']:
        # without -save_name the save_path gets a fresh timestamp+rand suffix
        # per launch, so a relaunch could never find the previous checkpoint
        raise SystemExit('-auto_resume requires -save_name (the default '
                         'save_path is timestamped per launch, so a relaunch '
                         'would never resolve the previous run)')
    check_world(parsed)
    return parsed


_LAUNCH = ("launch one process per card with -coordinator_address "
           "host:port -num_processes N -process_id r")


def check_world(parsed: dict):
    """Raise ``ValueError`` for world flags that name no world of one
    process per card: ``-coordinator_address`` without ``-num_processes``
    >= 1 and ``0 <= -process_id < -num_processes``; ``-n_gpus`` other than
    0 (the world as launched) or the world's size (``-num_processes``
    under ``-coordinator_address``, else 1); ``-mesh_mp`` above 1 without
    ``-coordinator_address``, or one that does not divide the world's
    size."""
    n = parsed["num_processes"] if parsed["coordinator_address"] else 1
    mp = parsed["mesh_mp"]
    if parsed["coordinator_address"] and not (
            n >= 1 and 0 <= parsed["process_id"] < n):
        raise ValueError(
            f"-coordinator_address {parsed['coordinator_address']} needs "
            "-num_processes >= 1 and 0 <= -process_id < -num_processes "
            f"(got {parsed['num_processes']}, {parsed['process_id']})")
    if parsed["n_gpus"] > 0 and parsed["n_gpus"] != n:
        raise ValueError(
            f"-n_gpus {parsed['n_gpus']} in a world of {n} process(es): "
            "one process drives one card, so -n_gpus is 0 or the world's "
            f"size; {_LAUNCH}")
    if mp > 1 and not parsed["coordinator_address"]:
        raise ValueError(
            f"-mesh_mp {mp} without a world: one process drives one card, "
            f"so an mp axis of {mp} is {mp} processes; {_LAUNCH}")
    if mp < 1 or n % mp:
        raise ValueError(f"-mesh_mp {mp} does not divide the world's {n} "
                         "processes")
