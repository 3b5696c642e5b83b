"""Phase-2 dense-annotation finetuning.

The port's counterpart of the JAX package's ``cli/dense_finetune.py`` (the
reference's dense_annotation_finetuning.py): one image a step, all 100
candidates of the annotated round with the GT first and the others in a
permutation drawn from the host generator (:163-166), loss =
neuralNDCG_transposed(softmax(nsp)[:, 0], relevance) + lm + nsp_coeff *
nsp (:263-294), gradient accumulation by batch_multiply (16 in the
paper's recipe), a full reference-format ``.ckpt`` (weights, optimizer,
scheduler) each epoch and NSP val ranking from the second save on. On the
card the text attention blocks run on B5 forward and backward at B 100,
the update on B7 under -fused_adamw 1, the val ranking on B4 and K2.

Usage: python -m unimm_torch.cli.dense_finetune -batch_multiply 16 ... (on
the card; ``main(argv, device="cpu")`` runs the plain versions on the
CPU). Across processes, one per card (the flags of ``cli/train.py``,
``-mesh_mp`` included: the parameters and moments sharded over each mp
group): every rank loads the same dialog and option order, the slate is
padded from 100 rows to the next multiple of the dp size with neutralised
copies of the GT row (lm_weight 0, labels -1), and each dp index takes its
contiguous block of it (the JAX package's dp-sharded slate, the
reference's 100 -> 25/25/25/25 scatter). The NSP logits are gathered over
the dp group with their gradient (``dist.gather_rows``) and cut to the 100
real rows before the NSP and the listwise ranking losses, which every rank
then computes on the whole slate; the LM loss is each rank's sum over the
slate's label count. Rank 0 writes the checkpoints. The JAX package
refuses an mp axis that spans processes here (its dp blocks would not be
contiguous in its device order); the port's mp axis is processes, so it
runs dense finetuning under ``-mesh_mp`` as the JAX package does in one
process.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from unimm_torch import checkpoint as C
from unimm_torch.cli import common, options
from unimm_torch.cli.train import load_lang, make_optimizer, to_device
from unimm_torch.config import VilbertConfig
from unimm_torch.data.dataset import (VisdialDataset, VisdialDatasetDense,
                                      flatten_for_forward)
from unimm_torch.data.loader import DataLoader, batch_iter
from unimm_torch.eval import evaluator
from unimm_torch.models import unimm, vilbert
from unimm_torch.ops import focal_losses as FL
from unimm_torch.ops import losses as L
from unimm_torch.ops import masks
from unimm_torch.ops import rank_loss as RL
from unimm_torch.parallel import dist, mesh
from unimm_torch.train import step as tstep
from unimm_torch.utils.logging import MetricsLogger

N_SLATE = 100
_SLATE_KEYS = ("tokens", "segments", "positions", "sep_indices",
               "mlm_labels", "lm_weight", "mode", "ctx_end", "ans_len",
               "hist_len", "next_sentence_label")


def _dense_parts(view, cfg, batch, gt_relevance, *, rng, nsp_coeff, dtype,
                 decoder_bias, n_real):
    t_seq, v_seq, pt, pv = unimm.encode(view, cfg, batch, dtype=dtype,
                                        train=True, rng=rng)
    lm, _, nsp_logits = unimm.lm_loss_and_heads(
        view, cfg, t_seq, v_seq, pt, pv, batch, train=True, rng=rng,
        decoder_bias=decoder_bias)
    # the whole slate's logits on every rank, the padding rows cut away
    nsp_logits = dist.gather_rows(nsp_logits, over=dist.DP)[:n_real]
    nsp = L.nsp_loss(nsp_logits, dist.gather_rows(
        batch["next_sentence_label"], over=dist.DP)[:n_real])
    nsp_probs = torch.softmax(nsp_logits.float(), dim=-1)[:, 0]
    rank = RL.neuralNDCG_transposed(nsp_probs[None, :], gt_relevance[None, :])
    # the reference drops the lm term when it is NaN (:291-294); the
    # masked-sum loss cannot make one, so this only keeps the value rule
    def objective(lm):
        lm_term = torch.where(torch.isnan(lm), torch.zeros_like(lm), lm)
        return rank + lm_term + nsp_coeff * nsp

    total = objective(lm)
    # logged: the world's lm loss (this rank's share summed over the dp
    # group) and the logging-only quantities (:275-280)
    lm_world = tstep.world_metrics({"lm": lm.detach()})["lm"]
    slate = nsp_logits.detach().float()[None, :, :]
    return total, {"loss": objective(lm_world).detach(), "lm_loss": lm_world,
                   "nsp_loss": nsp.detach(), "rank_loss": rank.detach(),
                   "ce_loss": FL.dense_ce_log(slate, gt_relevance[None, :]),
                   "qfocal_loss": FL.dense_qfocal_log(
                       slate, gt_relevance[None, :])}


def make_dense_step(cfg: VilbertConfig, *, nsp_coeff=1.0,
                    dtype=torch.bfloat16, n_real: int = N_SLATE):
    """Returns ``step(state, batch, gt_relevance) -> (state, parts)``: one
    forward over the slate (a flat [100, ...] batch of tensors on the
    model's device, GT first) in ``dtype``, the rank + lm + nsp_coeff * nsp
    loss, its backward and one optimizer call (state: ``train.step.
    init_state``'s dict). ``parts``: device scalars loss, lm_loss,
    nsp_loss, rank_loss and the logging-only ce_loss and qfocal_loss. In a
    world of several processes ``batch`` is this dp index's block of the
    ``n_real``-row slate padded by ``slate_block``; the parts are the
    world's."""

    def step(state, batch, gt_relevance):
        model = state["model"]
        rng = vilbert.DropoutRng(tstep.step_seed(state["seed"],
                                                 state["step"],
                                                 tstep.world_rank()),
                                 batch["tokens"].device)
        batch = tstep.world_norms(batch)
        total, parts = vilbert.call_in_dtype(
            model, dtype, _dense_parts, cfg, batch, gt_relevance, rng=rng,
            nsp_coeff=nsp_coeff, dtype=dtype,
            decoder_bias=model.cls.predictions.bias, n_real=n_real)
        for p in model.parameters():
            p.grad = None
        total.backward()
        state["opt"].step()
        state["step"] += 1
        return state, parts

    return step


def gt_first_order(gt: int, host_rng) -> np.ndarray:
    """The slate's option order: the GT first, the others permuted
    (dense_annotation_finetuning.py:163-166)."""
    others = np.concatenate([np.arange(gt), np.arange(gt + 1, N_SLATE)])
    return np.concatenate([[gt], host_rng.permutation(others)])


def bucket_slate(flat: dict, cfg: VilbertConfig, length_buckets: int):
    """Cut the slate's per-token arrays to its covering length bucket
    (exact under the descriptor masks; every option shares the annotated
    round's context), at quarter granularity at the finest."""
    div = min(length_buckets, 4) if length_buckets >= 2 else 4
    ext = masks.attended_extent(flat["mode"], flat["ctx_end"],
                                flat["ans_len"], cfg.max_seq_len,
                                flat.get("mlm_labels"))
    Lb = masks.quarter_bucket(int(ext.max()), cfg.max_seq_len, div=div)
    if Lb < cfg.max_seq_len:
        for key in ("tokens", "segments", "positions", "mlm_labels",
                    "lm_weight"):
            if key in flat:
                flat[key] = np.ascontiguousarray(
                    np.asarray(flat[key])[:, :Lb])
    return flat


def slate_block(flat: dict, n_real: int = N_SLATE) -> dict:
    """This dp index's contiguous block of the ``n_real``-row slate padded
    to the next multiple of the dp size with copies of the GT row whose LM
    term is neutralised (lm_weight 0, labels -1; their NSP rows are cut
    away after the gather); the slate itself on a dp axis of one index."""
    world = dist.dp_size()
    pad = -n_real % world
    if world == 1:
        return flat
    flat = {k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)])
            for k, v in flat.items()}
    if "lm_weight" in flat:
        flat["lm_weight"][n_real:] = 0
    flat["mlm_labels"][n_real:] = -1
    rows = dist.row_block(n_real + pad, over=dist.DP)
    return {k: v[rows] for k, v in flat.items()}


def main(argv=None, device=None, backend=None):
    params = options.read_command_line(argv)
    dev = common.setup_torch(params, device, backend)
    os.makedirs(params["save_path"], exist_ok=True)
    viz = MetricsLogger(os.path.join(params["save_path"], "logs"),
                        enable=dist.rank() == 0)
    cfg = common.build_config(params)
    tokenizer = common.load_tokenizer(params)
    reader = common.open_reader(params)

    params = dict(params, num_options=N_SLATE)
    dataset = VisdialDatasetDense(params, tokenizer, reader)
    loader = DataLoader(dataset, 1, shuffle=True, drop_last=True,
                        num_workers=params["num_workers"],
                        seed=params["seed"])
    eval_dataset = VisdialDataset(params, tokenizer, reader)
    eval_dataset.split = "val"
    num_iter_epoch = max(len(loader), 1) if not params["overfit"] else 1
    print(f"\n{num_iter_epoch} iter per epoch.")

    # resume (reference dense_annotation_finetuning.py:95-130): -continue
    # restores weights + AdamW moments + schedule position from a full
    # .ckpt; -auto_resume picks this run's own latest .ckpt if one exists,
    # else starts fresh with -start_path as the warm-start
    resume_path = (params["start_path"]
                   if params["continue"] and params["start_path"] else None)
    auto_hit = False
    if params["auto_resume"] and resume_path is None:
        latest = C.latest_reference_ckpt(params["save_path"])
        if latest is None:
            print(f"auto_resume: no .ckpt under {params['save_path']!r} — "
                  "fresh start")
        else:
            resume_path = latest[0]
            auto_hit = True
    init_params_dict = dict(params, start_path="") if resume_path else params
    model = mesh.shard_model(common.init_model(init_params_dict, cfg, dev))
    model.train().requires_grad_(True)
    lang = load_lang(params)
    opt = make_optimizer(params, model, lang)
    state = tstep.init_state(model, opt, seed=params["seed"])
    start_iter = 0
    if resume_path:
        _, _, iter0, n = C.load_reference_train_state(
            resume_path, model, opt, batch_multiply=params["batch_multiply"])
        print(f"dense -continue from {resume_path}: {n} tensors, "
              f"iter_id {iter0}, Adam moments + schedule restored")
        state["step"] = start_iter = iter0
    dtype = common.compute_dtype(params)
    dense_step = make_dense_step(cfg, nsp_coeff=params["nsp_loss_coeff"],
                                 dtype=dtype)

    host_rng = np.random.default_rng(params["seed"])
    start_t = time.perf_counter()
    # -auto_resume completes the ORIGINAL epoch budget (idempotent under an
    # auto-relauncher); -continue keeps the reference's train-num_epochs-
    # more semantics (dense_annotation_finetuning.py:146-147)
    done_epochs = (start_iter // max(1, num_iter_epoch)
                   if auto_hit and not params["overfit"] else 0)
    if done_epochs >= params["num_epochs"]:
        print(f"auto_resume: dense run already complete at iter {start_iter} "
              f"({done_epochs}/{params['num_epochs']} epochs) — nothing to do")

    def save_ckpt(it):
        # the reference's 4-key dict (model + optimizer + scheduler +
        # iter_id, :324-326), so dense runs resume via -continue and
        # -auto_resume
        C.save_reference_ckpt(
            os.path.join(params["save_path"],
                         f"visdial_dialog_encoder_{it}.ckpt"),
            model, it, opt=opt,
            lang_set=C.language_param_set(lang) if lang else set(),
            lr=params["lr"], image_lr=params["image_lr"])
        viz.save()  # persist the plot env at ckpt time (dense:329)

    last_saved = start_iter
    for epoch_id, idx, batch in batch_iter(loader, params["num_epochs"],
                                           start_epoch=done_epochs):
        # the startIterID offset as the reference's (:147); under an
        # -auto_resume hit epoch_id is absolute (earlier epochs skipped)
        iter_id = (idx + epoch_id * num_iter_epoch if auto_hit
                   else start_iter + idx + epoch_id * num_iter_epoch)

        order = gt_first_order(int(batch["gt_option"][0]), host_rng)
        flat = flatten_for_forward(
            {k: (v[:, :, order] if k in _SLATE_KEYS else v)
             for k, v in batch.items() if k not in
             ("gt_relevance", "gt_option", "round_id", "image_id")})
        gt_rel = np.asarray(batch["gt_relevance"][0])[order]
        if params["length_buckets"]:
            flat = bucket_slate(flat, cfg, params["length_buckets"])
        flat = slate_block(flat)
        with torch.enable_grad():
            state, parts = dense_step(
                state, to_device(flat, dev),
                torch.from_numpy(np.ascontiguousarray(gt_rel)).to(dev))

        if iter_id % 10 == 0:
            m = {k: float(v) for k, v in parts.items()}
            dt = time.perf_counter() - start_t
            start_t = time.perf_counter()
            print(f"[Ep: {epoch_id:.2f}][Iter: {iter_id}][Time: {dt:5.2f}s]"
                  f"[loss: {m['loss']:.3g}][LM Loss: {m['lm_loss']:.3g}]"
                  f"[NSP Loss: {m['nsp_loss']:.3g}]"
                  f"[CE Loss: {m['ce_loss']:.3g}]"
                  f"[qfocal_loss: {m['qfocal_loss']:.3g}]"
                  f"[neuralNDCG_transposed loss: {m['rank_loss']:.3g}]")
            for k, v in m.items():
                viz.line_plot(iter_id, v, "loss", k)

        epoch_len = 100 if params["overfit"] else num_iter_epoch
        # `> start_iter`: the first step of a resumed run lands on the
        # restored iter_id, and a save there would overwrite the restored
        # checkpoint with a one-step-newer state under the same label
        if iter_id % epoch_len == 0 and iter_id > start_iter:
            save_ckpt(iter_id)
            last_saved = iter_id
            if iter_id // epoch_len >= 2:
                eval_loader = DataLoader(
                    eval_dataset, 5 if params["overfit"] else 4,
                    shuffle=False, drop_last=True,
                    num_workers=params["num_workers"])
                with torch.no_grad():
                    mets = evaluator.evaluate_split(
                        model, cfg, eval_loader, mode="nsp",
                        chunk_size=params["eval_chunk"], dtype=dtype,
                        split_rows=True, device=dev)
                for name, value in mets.items():
                    print(f"{name}: {value}")
    if params["auto_resume"] and not params["overfit"]:
        # the final epoch's end state is never saved by the reference's
        # epoch-boundary placement: without this an auto-relauncher would
        # redo the tail epoch forever
        final_iter = params["num_epochs"] * num_iter_epoch
        if final_iter > max(last_saved, start_iter):
            save_ckpt(final_iter)
    viz.close()
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
