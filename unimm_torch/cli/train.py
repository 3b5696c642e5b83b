"""Sparse-annotation unified training (UniMM / UniMM-UL).

The port's counterpart of the JAX package's ``cli/train.py`` (the
reference's train.py:292-543): per-image items of 10 rounds x (1 positive
+ N negatives), per-sequence dis/gen mode by train_dis_rate, subsampled to
``batch_size`` sequences, one training step (forward, losses, backward and
the grouped AdamW; on the card the text attention blocks run on B5 and,
under -fused_adamw 1, the update on B7), a checkpoint every
``save_every_epochs`` (a reference-format ``.ckpt`` and a native
``native/step_<n>/``), discriminative val ranking every
``eval_every_epochs`` (the flat scorer: B4 and K2 on the card).

Usage: python -m unimm_torch.cli.train -batch_size 240 -lr 2e-5 ... (on
the card; ``main(argv, device="cpu")`` runs the plain versions on the
CPU). Across processes, one per card: add ``-coordinator_address
host:port -num_processes N -process_id r`` to each rank's command, and
``-mesh_mp M`` to shard the parameters and the Adam moments over groups of
M ranks (``parallel/mesh.py``; the world is dp x M, ``parallel/dist.py``).
Every dp index computes the same global shuffle and loads its slice of
each global batch (``-batch_size`` stays global: each dp index subsamples
``batch_size // dp`` sequences from its images, with its own generator;
the ranks of an mp group load the same rows), the losses take the dp
group's denominators and the gradients are summed over it
(``train/step.py``); length-bucketed morsels agree on their bucket
lengths and normalisers across the dp group; rank 0 writes the
checkpoints (whole tensors) and the logs, and every rank restores its
slices of the same file; the val ranking splits every chunk's rows over
the dp group.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from unimm_torch import checkpoint as C
from unimm_torch.cli import common, options
from unimm_torch.data.dataset import (VisdialDataset, flatten_for_forward,
                                      length_bucket_morsels)
from unimm_torch.data.loader import DataLoader
from unimm_torch.eval import evaluator
from unimm_torch.parallel import dist, mesh
from unimm_torch.train import optim, step as tstep
from unimm_torch.utils import trace
from unimm_torch.utils.logging import MetricsLogger


def to_device(flat: dict, dev) -> dict:
    """A flat numpy batch as tensors on ``dev`` (the span ``train.h2d``)."""
    with trace.span("train.h2d"):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in flat.items()}


def _log_step(iter_id, metrics, num_iter_epoch, dataset, viz, start_t):
    m = {k: float(v) for k, v in metrics.items()}
    dt = time.perf_counter() - start_t
    overflow = int(m.get("label_budget_overflow", 0))
    fallbacks = dataset.stats["neg_truncation_fallbacks"]
    print(f"[Ep: {iter_id / num_iter_epoch:.2f}][Iter: {iter_id}]"
          f"[Time: {dt:5.2f}s]"
          f"[NSP + LM Loss: {m['lm_loss'] + m['nsp_loss']:.3g}]"
          f"[LM Loss: {m['lm_loss']:.3g}]"
          f"[NSP Loss: {m['nsp_loss']:.3g}]"
          f"[IMG Loss: {m['img_loss']:.3g}]"
          f"[LabelOverflow: {overflow}]"
          f"[NegFallbacks: {fallbacks}]")
    viz.line_plot(iter_id, m["loss"], "loss", "tot loss")
    viz.line_plot(iter_id, m["lm_loss"], "loss", "lm loss")
    viz.line_plot(iter_id, m["nsp_loss"], "loss", "nsp loss")
    viz.line_plot(iter_id, m["img_loss"], "loss", "img loss")


def make_optimizer(params: dict, model, lang):
    """The CLI's grouped AdamW (-lr, -image_lr, -batch_multiply,
    -adam_mu_dtype), fused under -fused_adamw 1."""
    ocfg = optim.OptimConfig(lr=params["lr"], image_lr=params["image_lr"],
                             batch_multiply=params["batch_multiply"],
                             mu_dtype=params["adam_mu_dtype"] or None)
    make = (optim.make_fused_optimizer if params["fused_adamw"]
            else optim.make_optimizer)
    return make(model, ocfg, lang)


def load_lang(params: dict):
    if os.path.exists(params["language_weights"]):
        return optim.load_language_weights(params["language_weights"])
    return None


def main(argv=None, device=None, backend=None):
    params = options.read_command_line(argv)
    dev = common.setup_torch(params, device, backend)
    # the rows follow the dp axis: an mp group's ranks load the same ones
    nproc, rank = dist.dp_size(), dist.dp_rank()
    os.makedirs(params["save_path"], exist_ok=True)
    viz = MetricsLogger(os.path.join(params["save_path"], "logs"),
                        enable=dist.rank() == 0)
    print({k: v for k, v in sorted(params.items())})

    cfg = common.build_config(params)
    tokenizer = common.load_tokenizer(params)
    reader = common.open_reader(params)

    dataset = VisdialDataset(params, tokenizer, reader)
    dataset.split = "train"
    images_per_batch = (params["batch_size"] // params["sequences_per_image"]
                        or 1) if not params["overfit"] else 5
    images_per_batch = min(images_per_batch, max(1, len(dataset)))
    loader = DataLoader(dataset, images_per_batch, shuffle=True,
                        drop_last=True, num_workers=params["num_workers"],
                        seed=params["seed"], process_index=rank,
                        process_count=nproc)
    num_iter_epoch = max(len(loader), 1)
    print(f"\n{len(dataset)} train data.")
    print(f"\n{num_iter_epoch} iter per epoch.")

    # -auto_resume (preemption-safe restart; the reference's recovery is a
    # manual -continue): resume from this run's own native checkpoint
    # directory when one exists, else start fresh with -start_path as the
    # ordinary warm-start
    auto_src = None
    if params["auto_resume"] and not params["continue"]:
        auto_dir = os.path.join(params["save_path"], "native")
        if C.latest_native(auto_dir) is not None:
            auto_src = auto_dir
        else:
            print(f"auto_resume: no checkpoint under {auto_dir!r} — "
                  "fresh start")
    # under -continue (or an auto-resume hit) the restore below loads the
    # complete train state, not a weights-only load from start_path
    init_params_dict = (dict(params, start_path="")
                        if params["continue"] or auto_src else params)
    # the whole fp32 model, then this rank's slices, then the optimizer
    # (its moments shaped like the slices)
    model = mesh.shard_model(common.init_model(init_params_dict, cfg, dev))
    model.train().requires_grad_(True)

    lang = load_lang(params)
    opt = make_optimizer(params, model, lang)
    state = tstep.init_state(model, opt, seed=params["seed"])

    start_iter = 0
    resume_path = (params["start_path"]
                   if params["continue"] and params["start_path"]
                   else auto_src)
    if resume_path:
        if os.path.isfile(resume_path):
            # reference-format .ckpt: weights + AdamW moments + schedule
            # position (reference train.py:371-386)
            _, _, iter0, n = C.load_reference_train_state(
                resume_path, model, opt,
                batch_multiply=params["batch_multiply"])
            print(f"-continue from reference .ckpt: {n} tensors, "
                  f"iter_id {iter0}, Adam moments + schedule restored")
            state["step"] = iter0
        else:
            latest = C.latest_native(resume_path)
            if latest is None:
                # training from random weights under -continue would
                # overwrite the run
                raise FileNotFoundError(
                    f"-continue: no native checkpoint under "
                    f"{resume_path!r}")
            C.restore_native(latest[0], state)
        start_iter = state["step"]
        print(f"restored native checkpoint at step {start_iter}")

    dtype = common.compute_dtype(params)
    train_step = tstep.make_train_step_with_fallback(
        cfg, policy=params["label_overflow_policy"],
        lm_coeff=params["lm_loss_coeff"],
        nsp_coeff=params["nsp_loss_coeff"],
        img_coeff=params["img_loss_coeff"], dtype=dtype)
    nsp_weight = torch.tensor([float(params["num_negative_samples"]), 1.0],
                              device=dev)

    # this rank's share of the global sequence batch, drawn from its own
    # images with its own generator
    sample_size = (48 if params["overfit"] else params["batch_size"]) // nproc
    host_rng = np.random.default_rng(
        params["seed"] if nproc == 1 else (params["seed"], rank))

    # length-bucketed accumulation: buffer batch_multiply flats, sort all
    # their sequences by attended extent and run the accumulation
    # micro-steps at per-morsel quarter-length buckets; the ranks agree on
    # each morsel's bucket and on the group normalisers
    k_buckets = (params["batch_multiply"]
                 if params["length_buckets"] and
                 params["batch_multiply"] > 1 else 1)
    morsel_sync = ((lambda stats: np.stack(dist.allgather_np(
        stats, over=dist.DP))) if nproc > 1 else None)
    bucket_div = (params["length_buckets"]
                  if params["length_buckets"] >= 2 else 4)
    flat_buffer = []

    iter_id = start_iter
    profiler = common.StepProfiler(params["profile_dir"])
    start_t = time.perf_counter()

    def run_morsels(morsels):
        nonlocal iter_id, state, start_t
        for flat in morsels:
            iter_id += 1
            profiler.step(iter_id)
            host_labels = flat["mlm_labels"]
            with torch.enable_grad():
                state, metrics = train_step(state, to_device(flat, dev),
                                            nsp_weight,
                                            host_mlm_labels=host_labels)
            if iter_id % 100 == 0:
                _log_step(iter_id, metrics, num_iter_epoch, dataset,
                          viz, start_t)
                start_t = time.perf_counter()
            if params["overfit"] and iter_id % 100 == 0:
                return True
        return False

    def save_checkpoint():
        C.save_native(os.path.join(params["save_path"], "native"), state,
                      iter_id)
        C.save_reference_ckpt(
            os.path.join(params["save_path"],
                         f"visdial_dialog_encoder_{iter_id}.ckpt"),
            model, iter_id, opt=opt,
            lang_set=C.language_param_set(lang) if lang else set(),
            lr=params["lr"], image_lr=params["image_lr"])
        viz.save()  # persist the plot env at ckpt time (train.py:506)

    # -auto_resume completes the ORIGINAL epoch budget (an identical
    # relaunch of a finished run does nothing, so an auto-relauncher
    # terminates); -continue keeps the reference semantics of training
    # num_epochs MORE on top of the restored state (train.py:405-407)
    done_epochs = (start_iter // max(1, num_iter_epoch)
                   if auto_src and not params["overfit"] else 0)
    if done_epochs >= params["num_epochs"]:
        print(f"auto_resume: run already complete at step {start_iter} "
              f"({done_epochs}/{params['num_epochs']} epochs) — nothing to do")
    for epoch_id in range(1 + done_epochs, params["num_epochs"] + 1):
        loader.set_epoch(epoch_id)
        stop_epoch = False
        for batch in loader:
            # length-bucketed morsels need expanded per-sequence image rows
            flat = flatten_for_forward(batch, sample_size=sample_size,
                                       rng=host_rng,
                                       compact_images=k_buckets == 1)
            if k_buckets > 1:
                flat_buffer.append(flat)
                if len(flat_buffer) < k_buckets:
                    continue
                morsels = length_bucket_morsels(flat_buffer,
                                                cfg.max_seq_len, k_buckets,
                                                div=bucket_div,
                                                sync=morsel_sync)
                flat_buffer = []
            else:
                morsels = [flat]
            if run_morsels(morsels):
                stop_epoch = True
                break
        if flat_buffer and not stop_epoch:
            # epoch-end remainder (num_iter_epoch % batch_multiply != 0):
            # flushed as a shorter morsel group, so no loader batch is
            # dropped
            run_morsels(length_bucket_morsels(flat_buffer, cfg.max_seq_len,
                                              len(flat_buffer),
                                              div=bucket_div,
                                              sync=morsel_sync))
            flat_buffer = []

        if epoch_id % params["save_every_epochs"] == 0:
            save_checkpoint()

        if epoch_id % params["eval_every_epochs"] == 0:
            dataset.split = "val"
            eval_loader = DataLoader(dataset, 5 if params["overfit"] else 4,
                                     shuffle=False, drop_last=True,
                                     num_workers=params["num_workers"])
            with torch.no_grad():
                all_metrics = evaluator.evaluate_split(
                    model, cfg, eval_loader, mode="nsp",
                    chunk_size=params["eval_chunk"], dtype=dtype,
                    split_rows=True, pipeline_depth=params["eval_pipeline"],
                    device=dev)
            for name, value in all_metrics.items():
                print(f"{name}: {value}")
                key = ("Retrieval Round Val Metrics" if "round" in name
                       else "Retrieval Val Metrics")
                viz.line_plot(iter_id, value, key, name)
            dataset.split = "train"
    if (params["auto_resume"] and iter_id > start_iter
            and params["num_epochs"] % params["save_every_epochs"] != 0):
        # the final epoch's end state was never checkpointed (saves land on
        # save_every_epochs boundaries): without this an auto-relauncher
        # would redo the tail epochs forever
        save_checkpoint()
    profiler.close()
    viz.close()
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
