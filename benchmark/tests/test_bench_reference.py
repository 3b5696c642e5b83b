"""The plain reference against the program's plain path at a tiny size,
on the CPU: the same weights (``make_weights``, loaded into the program's
model), the same inputs, fp32. Eval scores, the training loss and
gradients under the program's dropout streams, blocks of rows adding up
to the whole batch, and one AdamW update."""

import numpy as np
import torch

from benchmark.harness import traffic
from benchmark.loops import train_steps
from benchmark.reference import vilbert_ref as ref
from benchmark.tests._tiny import GROWTH, NARROW_MODEL
from unimm_torch.config import VilbertConfig
from unimm_torch.models import unimm, vilbert
from unimm_torch.train import optim

CFG = dict(NARROW_MODEL)
STD = 0.2       # wide weights, so that every score depends on its inputs


def _model(cfg, W, impl):
    pcfg = VilbertConfig.from_dict(cfg).replace(attention_impl=impl)
    m = vilbert.empty_model(pcfg, "cpu")
    m.load_state_dict(W, strict=True)
    return pcfg, m


def _flat(b):
    B, R, O = b["tokens"].shape[:3]
    out = {k: torch.from_numpy(np.ascontiguousarray(
        b[k].reshape((B * R * O,) + b[k].shape[3:])))
        for k in ("tokens", "segments", "mode", "ctx_end", "ans_len",
                  "mlm_labels")}
    for k in ("image_feat", "image_loc", "image_mask"):
        v = np.repeat(b[k], R * O, axis=0)
        out[k] = torch.from_numpy(v)
    return out


def test_eval_scores_match_program_plain_path():
    W = ref.make_weights(CFG, 5, STD, "cpu")
    pcfg, m = _model(CFG, W, "xla")
    for layout in ("gen", "dis"):
        mix = {"kind": "slates", "layout": layout, "dialogs": 2,
               "rounds": 2, "options": 3, "ctx_growth": GROWTH,
               "ans_range": [2, 9], "loader_batch": 2, "coalesce": 1,
               "size_seed": 1}
        pool, _ = traffic.make(mix, CFG, 11)
        b = _flat(pool[0])
        got = ref.score(CFG, W, b, ref.Precision("fp32"))
        want = unimm.forward_eval(m, pcfg, b, dtype=torch.float32)
        nsp = want["nsp_logits"]
        torch.testing.assert_close(got["nsp_margin"], nsp[:, 0] - nsp[:, 1],
                                   rtol=1e-4, atol=1e-4)
        if layout == "gen":
            torch.testing.assert_close(got["ll_sum"], -want["lm_nll_sum"],
                                       rtol=1e-4, atol=1e-4)


def _train_batch(seed):
    mix = {"kind": "train", "batch": 6, "pool": 1, "ctx_range": [20, 50],
           "ans_range": [2, 9], "labels_range": [3, 9],
           "unlikelihood_share": 0.25, "size_seed": 2}
    pool, _ = traffic.make(mix, CFG, seed)
    return {k: torch.from_numpy(v) for k, v in pool[0].items()}


def test_training_loss_and_gradients_match_program():
    """Under the program's training dropout (device masks and the text
    attention's Philox stream, drawn again by the reference), in fp32."""
    cfg = dict(CFG, mlm_loss_impl="gathered", max_train_label_positions=160)
    W = ref.make_weights(cfg, 8, STD, "cpu")
    pcfg, m = _model(cfg, W, "pallas_block")
    m.train().requires_grad_(True)
    b = _train_batch(3)
    seed = train_steps.step_seed(2 ** 33 + 5, 0)
    with torch.enable_grad():
        parts = unimm.forward_train(m, pcfg, b, rng=vilbert.DropoutRng(
            seed, "cpu"), nsp_weight=torch.tensor([1.0, 1.0]),
            dtype=torch.float32)
        want = parts["lm"] + parts["nsp"] + parts["img"]
        want.backward()
    Wr = {k: v.clone().requires_grad_(True) for k, v in W.items()}
    norms = ref.world_norms(b)
    got = 0.0
    for rows in (slice(0, 4), slice(4, 6)):       # two blocks of rows
        loss = ref.train_loss(cfg, Wr, {k: v[rows] for k, v in b.items()},
                              norms, seed=seed, batch=6, rows=rows,
                              prec=ref.Precision("fp32"),
                              nsp_weight=[1.0, 1.0])
        loss.backward()
        got += float(loss.detach())
    want = float(want.detach())
    assert abs(got - want) < 1e-4 * abs(want)
    grads = dict(m.named_parameters())
    for name in ("bert.encoder.layer.0.attention.self.query.weight",
                 "bert.encoder.c_layer.1.biattention.key1.weight",
                 "bert.encoder.v_layer.1.output.dense.weight",
                 "bert.embeddings.word_embeddings.weight"):
        torch.testing.assert_close(Wr[name].grad, grads[name].grad,
                                   rtol=2e-3, atol=1e-6)


def test_adamw_matches_program_optimizer():
    cfg = dict(CFG)
    o = {"lr": 2e-5, "image_lr": 2e-5, "warmup_steps": 10,
         "t_total": 200000, "min_lr": 1e-5, "weight_decay": 0.01,
         "adam_eps": 1e-6, "batch_multiply": 1}
    W = ref.make_weights(cfg, 4, STD, "cpu")
    _, m = _model(cfg, W, "xla")
    m.requires_grad_(True)
    gen = torch.Generator().manual_seed(0)
    grads = {n: torch.randn(p.shape, generator=gen)
             for n, p in m.named_parameters()}
    opt = optim.make_optimizer(m, optim.OptimConfig(**o), None)
    Wr = {k: v.clone() for k, v in W.items()}
    ropt = ref.AdamW(Wr, o)
    for _ in range(3):
        for n, p in m.named_parameters():
            p.grad = grads[n].clone()
        opt.step()
        ropt.step(Wr, grads)
    for n, p in m.named_parameters():
        torch.testing.assert_close(p.detach(), Wr[n], rtol=0, atol=1e-7)
