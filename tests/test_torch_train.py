"""The PyTorch port's training path against the JAX package on the same
weights and numpy inputs (TINY config, CPU, fp32): the losses, the
chunk-recomputing xent's gradients, forward_train's losses and gradients
on the kernel and plain paths, the grouped and fused optimizers, three
train steps, the label-overflow policies, the length-bucketed morsels and
dropout determinism. The JAX side runs its Pallas kernels in interpret
mode, as its own tests do; the port's kernel wrappers run their plain
twins on CPU tensors."""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_common import TINY, TINY_T, jax_params, jax_params_np, \
    torch_model
from tests.test_model import make_batch
from unimm_torch import checkpoint as tck
from unimm_torch.data import dataset as tds
from unimm_torch.models import unimm as tu
from unimm_torch.models import vilbert as tv
from unimm_torch.ops import losses as tl
from unimm_torch.train import optim as topt
from unimm_torch.train import step as tstep
from unimm_tpu.data import dataset as jds
from unimm_tpu.models import unimm as ju
from unimm_tpu.ops import losses as jl
from unimm_tpu.train import optim as jopt
from unimm_tpu.train import step as jstep

NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               v_hidden_dropout_prob=0.0, v_attention_probs_dropout_prob=0.0,
               head_dropout_prob=0.0)
LANG = jopt.load_language_weights(
    str(Path(__file__).resolve().parents[1] / "config"
        / "language_weights.json"))


def train_batch(rng, cfg, B=3):
    """A numpy training batch of the TINY shapes: gen descriptors, 6 labels
    per sequence (weight 1, the first sequence -1: unlikelihood), NSP
    labels and masked-region targets."""
    b = {k: np.asarray(v) for k, v in make_batch(rng, cfg, B=B).items()}
    L, R = cfg.max_seq_len, cfg.max_regions
    labels = np.full((B, L), -1, np.int32)
    labels[:, 3:9] = rng.integers(0, cfg.vocab_size, (B, 6))
    w = (labels != -1).astype(np.float32)
    w[0][labels[0] != -1] = -1.0
    w[1, 8] = 0.0                       # a label of weight 0
    b.update(mlm_labels=labels, lm_weight=w,
             next_sentence_label=rng.integers(0, 2, B).astype(np.int32),
             image_target=rng.dirichlet(np.ones(cfg.v_target_size),
                                        (B, R)).astype(np.float32),
             image_label=rng.choice([-1, 0, 1], (B, R)).astype(np.int32))
    return b


def to_torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_tree(tree):
    """A JAX pytree of arrays -> {reference name: torch-layout numpy}."""
    return {k: v.numpy() for k, v in tck.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


# --- (1) the losses ----------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(0)
    N, L, V, R, T = 3, 7, 11, 5, 13
    logits = rng.normal(size=(N, L, V)).astype(np.float32) * 3
    labels = rng.integers(-1, V, (N, L)).astype(np.int32)
    w = rng.choice([1.0, 2.0, -1.0, 0.0], (N, L)).astype(np.float32)
    nsp = rng.normal(size=(N, 2)).astype(np.float32)
    nsp_lab = np.array([0, 1, 1], np.int32)
    img = rng.normal(size=(N, R, T)).astype(np.float32)
    target = rng.dirichlet(np.ones(T), (N, R)).astype(np.float32)
    target[0, 0, :3] = 0.0
    img_lab = rng.choice([-1, 0, 1], (N, R)).astype(np.int32)
    nll = np.abs(rng.normal(size=(N, L))).astype(np.float32)
    t, j = (lambda a: torch.from_numpy(a)), jnp.asarray
    pairs = [
        (tl.masked_lm_ul_loss(t(logits), t(labels), t(w)),
         jl.masked_lm_ul_loss(j(logits), j(labels), j(w))),
        (tl.masked_lm_ul_loss(t(logits), t(labels), t(w), num_tokens=7.5),
         jl.masked_lm_ul_loss(j(logits), j(labels), j(w), num_tokens=7.5)),
        (tl.masked_lm_ul_loss_gathered(t(nll), t(labels), t(w)),
         jl.masked_lm_ul_loss_gathered(j(nll), j(labels), j(w))),
        (tl.nsp_loss(t(nsp), t(nsp_lab)), jl.nsp_loss(j(nsp), j(nsp_lab))),
        (tl.nsp_loss(t(nsp), t(nsp_lab), [2.0, 1.0], [1.5, 0.5]),
         jl.nsp_loss(j(nsp), j(nsp_lab), [2.0, 1.0], [1.5, 0.5])),
        (tl.masked_img_loss(t(img), t(target), t(img_lab)),
         jl.masked_img_loss(j(img), j(target), j(img_lab))),
        (tl.masked_img_loss(t(img), t(target), t(img_lab), norm=2.5),
         jl.masked_img_loss(j(img), j(target), j(img_lab), norm=2.5)),
        (tl.masked_img_loss_mse(t(img), t(target), t(img_lab)),
         jl.masked_img_loss_mse(j(img), j(target), j(img_lab))),
        (tl.masked_img_loss_mse(t(img), t(target), t(img_lab), norm=3.0),
         jl.masked_img_loss_mse(j(img), j(target), j(img_lab), norm=3.0)),
        (tl.combine_losses(1.5, 2.0, 3.0, 0.5, 2.0, 3.0),
         jl.combine_losses(1.5, 2.0, 3.0, 0.5, 2.0, 3.0)),
    ]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-6,
                                   err_msg=str(i))


# --- (2) the chunk-recomputing xent -----------------------------------------

def test_online_xent_vjp_matches_jax():
    rng = np.random.default_rng(0)
    M, H, V = 10, 16, 300
    h = rng.normal(size=(M, H)).astype(np.float32)
    w = (rng.normal(size=(V, H)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(V,)) * 0.1).astype(np.float32)
    lab = rng.integers(0, V, M).astype(np.int32)
    lab[0], lab[1], lab[2] = -1, V - 1, 0
    g = rng.normal(size=(M,)).astype(np.float32)

    def jf(h_, w_, b_):
        return jnp.sum(jl.online_softmax_xent_vjp(h_, w_, b_, jnp.asarray(lab),
                                                  128) * g)

    jv, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    th, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (h, w, b))
    nll = tl.online_softmax_xent_vjp(th, tw, tb, torch.from_numpy(lab), 128)
    assert float(nll[0].detach()) == 0.0
    tv_ = (nll * torch.from_numpy(g)).sum()
    tg = torch.autograd.grad(tv_, [th, tw, tb])
    np.testing.assert_allclose(float(tv_.detach()), float(jv), rtol=1e-5,
                               atol=1e-6)
    for a, b_ in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-5,
                                   atol=1e-6)


# --- (3) forward_train: losses and every parameter's gradient ----------------

@pytest.mark.parametrize("impl,mlm", [("pallas_block", "gathered"),
                                      ("pallas_block", "dense"),
                                      ("xla", "gathered"), ("xla", "dense"),
                                      ("pallas", "gathered")])
def test_forward_train_matches_jax(impl, mlm):
    cj = TINY.replace(attention_impl=impl, mlm_loss_impl=mlm, **NO_DROP)
    ct = TINY_T.replace(attention_impl=impl, mlm_loss_impl=mlm, **NO_DROP)
    b = train_batch(np.random.default_rng(1), cj)

    def jloss(p):
        o = ju.forward_train(p, cj, to_jax(b), rng=jax.random.PRNGKey(0),
                             dtype=jnp.float32)
        return o["lm"] + o["img"] + o["nsp"], o

    (_, jo), jg = jax.value_and_grad(jloss, has_aux=True)(jax_params())
    model = torch_model(ct).train().requires_grad_(True)
    to = tu.forward_train(model, ct, to_torch(b), dtype=torch.float32)
    (to["lm"] + to["img"] + to["nsp"]).backward()
    for k in ("lm", "img", "nsp"):
        np.testing.assert_allclose(float(to[k].detach()), float(jo[k]),
                                   rtol=1e-5, err_msg=k)
    want = torch_tree(jg)
    for name, p in model.named_parameters():
        got = (p.grad.numpy() if p.grad is not None
               else np.zeros(p.shape, np.float32))
        np.testing.assert_allclose(got, want[name], rtol=2e-4, atol=2e-4,
                                   err_msg=name)


# --- (3b) remat --------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_block"])
def test_remat_equals_no_remat(impl):
    """Under remat the recompute replays the dropout stream (the device
    masks and the block kernel's Philox seeds), so at the default dropouts
    the losses and every gradient equal the step without remat on the same
    DropoutRng seed. "pallas" trains through its kernel only at attention
    dropout 0 (whole text layers rematerialised); "pallas_block" keeps the
    attention block's Function and rematerialises the text FFN."""
    ct = TINY_T.replace(attention_impl=impl, head_dropout_prob=0.1)
    if impl == "pallas":
        ct = ct.replace(attention_probs_dropout_prob=0.0)
    b = to_torch(train_batch(np.random.default_rng(2), TINY))

    def run(cfg):
        model = torch_model(cfg).train().requires_grad_(True)
        o = tu.forward_train(model, cfg, b, dtype=torch.float32,
                             rng=tv.DropoutRng(5, "cpu"))
        (o["lm"] + o["img"] + o["nsp"]).backward()
        return ({k: float(v.detach()) for k, v in o.items()},
                {n: p.grad for n, p in model.named_parameters()})

    (lw, gw), (lr, gr) = run(ct), run(ct.replace(remat=True))
    assert lr == lw
    for name, g in gw.items():
        assert (g is None and gr[name] is None) or torch.equal(gr[name], g), \
            name


def test_forward_train_remat_matches_jax():
    """forward_train under remat against the JAX package's under remat, on
    the per-head kernel path at dropout 0."""
    cj = TINY.replace(attention_impl="pallas", remat=True, **NO_DROP)
    ct = TINY_T.replace(attention_impl="pallas", remat=True, **NO_DROP)
    b = train_batch(np.random.default_rng(8), cj)

    def jloss(p):
        o = ju.forward_train(p, cj, to_jax(b), rng=jax.random.PRNGKey(0),
                             dtype=jnp.float32)
        return o["lm"] + o["img"] + o["nsp"]

    jv, jg = jax.value_and_grad(jloss)(jax_params())
    model = torch_model(ct).train().requires_grad_(True)
    to = tu.forward_train(model, ct, to_torch(b), dtype=torch.float32)
    loss = to["lm"] + to["img"] + to["nsp"]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    want = torch_tree(jg)
    for name, p in model.named_parameters():
        got = (p.grad.numpy() if p.grad is not None
               else np.zeros(p.shape, np.float32))
        np.testing.assert_allclose(got, want[name], rtol=2e-4, atol=2e-4,
                                   err_msg=name)


# --- (4) the grouped and fused optimizers -----------------------------------

class _Named:
    """The ``named_parameters`` of a subset of the TINY parameters."""

    def __init__(self, named):
        self.named = named

    def named_parameters(self):
        return iter(self.named)


# leaves of all four groups: lang / img lr, decay / no decay (the
# biattention weight is exempt from decay by the reference's substring rule)
_LEAVES = [("bert", "embeddings", "word_embeddings"),
           ("bert", "embeddings", "LayerNorm", "weight"),
           ("bert", "encoder", "layer", "0", "attention", "self", "query",
            "kernel"),
           ("bert", "encoder", "layer", "0", "attention", "self", "query",
            "bias"),
           ("bert", "encoder", "v_layer", "0", "attention", "self", "key",
            "kernel"),
           ("bert", "encoder", "v_layer", "0", "attention", "self", "key",
            "bias"),
           ("bert", "encoder", "c_layer", "0", "biattention", "query1",
            "kernel"),
           ("cls", "predictions", "bias")]


def _subtree(tree):
    out = {}
    for path in _LEAVES:
        node, src = out, tree
        for k in path[:-1]:
            node, src = node.setdefault(k, {}), src[k]
        node[path[-1]] = src[path[-1]]
    return out


def _t(path, arr):
    a = np.asarray(arr)
    return np.ascontiguousarray(a.T if path[-1] == "kernel" else a)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("fused", [False, True])
def test_optimizers_match_jax(fused, k):
    params = _subtree(jax_params_np())
    labels = [tck.group_label(p, tck.language_param_set(LANG))
              for p in _LEAVES]
    assert sorted(set(labels)) == ["img_decay", "img_nodecay", "lang_decay",
                                   "lang_nodecay"]
    cfg = topt.OptimConfig(lr=1e-3, image_lr=5e-4, warmup_steps=2,
                           t_total=50, batch_multiply=k)
    jcfg = jopt.OptimConfig(lr=1e-3, image_lr=5e-4, warmup_steps=2,
                            t_total=50, batch_multiply=k)
    make_j = jopt.make_fused_optimizer if fused else jopt.make_optimizer
    tx = make_j(jax.tree_util.tree_map(jnp.asarray, params), jcfg, LANG)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    named = [(tck.torch_name(p), torch.from_numpy(_t(p, leaf)).clone())
             for p, leaf in zip(_LEAVES, [_subtree_leaf(params, p)
                                          for p in _LEAVES])]
    make_t = topt.make_fused_optimizer if fused else topt.make_optimizer
    opt = make_t(_Named(named), cfg, LANG)
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        u, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, u)
        opt.step([torch.from_numpy(_t(p, _subtree_leaf(g, p)))
                  for p in _LEAVES])
    adam = (js.inner_opt_state if k > 1 else js)[0]
    for i, path in enumerate(_LEAVES):
        for got, want in ((named[i][1].numpy(), _t(path, _subtree_leaf(
                              jp, path))),
                          (opt.mu[i].numpy(), _t(path, _subtree_leaf(
                              adam.mu, path))),
                          (opt.nu[i].numpy(), _t(path, _subtree_leaf(
                              adam.nu, path)))):
            # rtol, plus a floor at 1e-6 of the tensor's largest entry for
            # entries whose sums cancel (XLA contracts a * b + c into one
            # fused multiply-add in the fused kernel's interpret mode)
            np.testing.assert_allclose(
                got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                err_msg=str(path))


def _subtree_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_schedule_matches_jax():
    cfg = topt.OptimConfig(lr=1e-3, warmup_steps=10, t_total=100,
                           min_lr=1e-5)
    jcfg = jopt.OptimConfig(lr=1e-3, warmup_steps=10, t_total=100,
                            min_lr=1e-5)
    for scale in (1, 3):
        t = topt.warmup_linear_nonzero(1e-3, cfg, step_scale=scale)
        j = jopt.warmup_linear_nonzero(1e-3, jcfg, step_scale=scale)
        for s in (0, 1, 5, 10, 40, 99, 120):
            assert float(t(s)) == float(j(s)), (scale, s)


# --- (5) three train steps --------------------------------------------------

def test_three_train_steps_match_jax():
    cj = TINY.replace(**NO_DROP)
    ct = TINY_T.replace(**NO_DROP)
    lr = 1e-3
    ocfg = dict(lr=lr, image_lr=lr, warmup_steps=1, t_total=100)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params_np())
    tx = jopt.make_optimizer(params, jopt.OptimConfig(**ocfg), LANG)
    jstate = jstep.init_state(params, tx, seed=0)
    jtrain = jstep.make_train_step(cj, tx, dtype=jnp.float32, donate=False)
    model = torch_model(ct).train().requires_grad_(True)
    state = tstep.init_state(model, topt.make_optimizer(
        model, topt.OptimConfig(**ocfg), LANG), seed=0)
    ttrain = tstep.make_train_step(ct, dtype=torch.float32)
    nw = np.array([1.0, 2.0], np.float32)
    rng = np.random.default_rng(4)
    for step in range(3):
        b = train_batch(rng, cj)
        jstate, jm = jtrain(jstate, to_jax(b), jnp.asarray(nw))
        state, tm = ttrain(state, to_torch(b), torch.from_numpy(nw))
        for key in ("loss", "lm_loss", "nsp_loss", "img_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{step} {key}")
        assert int(tm["label_budget_overflow"]) == 0
    assert state["step"] == 3 and state["opt"].count == 3
    want = torch_tree(jstate["params"])
    for name, p in model.named_parameters():
        # Adam moves a parameter by about lr a step at most; a gradient
        # near zero whose sign differs costs at most 2 lr a step
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=6 * lr, err_msg=name)


# --- (6) the label-overflow policies -----------------------------------------

def test_label_overflow_policies():
    cfg = TINY_T.replace(max_train_label_positions=4, **NO_DROP)
    b = train_batch(np.random.default_rng(3), TINY)        # 6 labels > 4
    tb = to_torch(b)
    base = torch_model(cfg).train().requires_grad_(True)

    def fresh():
        m = copy.deepcopy(base)
        return tstep.init_state(m, topt.make_optimizer(
            m, topt.OptimConfig()))

    def run(step_fn, batch, **kw):
        return step_fn(fresh(), batch, **kw)[1]

    gathered = tstep.make_train_step(cfg, dtype=torch.float32)
    dense = tstep.make_train_step(cfg.replace(mlm_loss_impl="dense"),
                                  dtype=torch.float32)
    fb = tstep.make_train_step_with_fallback(cfg, policy="dense",
                                             dtype=torch.float32)
    m_fb = run(fb, tb, host_mlm_labels=b["mlm_labels"])
    m_d, m_g = run(dense, tb), run(gathered, tb)
    for key in ("loss", "lm_loss"):
        np.testing.assert_allclose(float(m_fb[key]), float(m_d[key]),
                                   rtol=1e-6, err_msg=key)
    assert abs(float(m_g["lm_loss"]) - float(m_fb["lm_loss"])) > 1e-4
    assert int(m_g["label_budget_overflow"]) == 3
    err = tstep.make_train_step_with_fallback(cfg, policy="error",
                                              dtype=torch.float32)
    with pytest.raises(ValueError, match="label budget overflow"):
        run(err, tb)
    ok = dict(b)
    ok["mlm_labels"] = np.where(np.arange(cfg.max_seq_len) < 6,
                                b["mlm_labels"], -1).astype(np.int32)
    ok["lm_weight"] = (ok["mlm_labels"] != -1).astype(np.float32)
    m_ok, m_ok_g = run(fb, to_torch(ok)), run(gathered, to_torch(ok))
    np.testing.assert_allclose(float(m_ok["loss"]), float(m_ok_g["loss"]),
                               rtol=1e-6)
    allow = tstep.make_train_step_with_fallback(cfg, policy="allow",
                                                dtype=torch.float32)
    np.testing.assert_allclose(float(run(allow, tb)["lm_loss"]),
                               float(m_g["lm_loss"]), rtol=1e-6)


# --- (7) length-bucketed morsels ---------------------------------------------

def test_length_bucket_morsels_match_jax():
    rng = np.random.default_rng(5)
    cfg = TINY
    flats = []
    for _ in range(3):
        b = train_batch(rng, cfg, B=4)
        b["mode"] = rng.integers(0, 2, 4).astype(np.int32)
        b["ctx_end"] = rng.integers(4, 20, 4).astype(np.int32)
        b["ans_len"] = np.where(b["mode"] == 1, rng.integers(1, 5, 4),
                                0).astype(np.int32)
        b["mlm_labels"][:, 9:] = -1
        flats.append(b)
    got = tds.length_bucket_morsels(flats, cfg.max_seq_len, 3)
    want = jds.length_bucket_morsels(flats, cfg.max_seq_len, 3)
    assert len(got) == len(want) == 3
    assert any(m["tokens"].shape[1] < cfg.max_seq_len for m in got)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(w[key]), err_msg=key)


# --- (8) dropout determinism -------------------------------------------------

def test_dropout_is_deterministic_per_seed():
    """All five dropouts at 0.1 on the kernel path (the Philox probability
    masks through the attention block's plain twin): one seed gives the
    same losses and gradients, another seed other losses."""
    ct = TINY_T.replace(attention_impl="pallas_block",
                        head_dropout_prob=0.1)
    b = to_torch(train_batch(np.random.default_rng(6), TINY))
    model = torch_model(ct).train().requires_grad_(True)

    def run(seed):
        o = tu.forward_train(model, ct, b, dtype=torch.float32,
                             rng=tv.DropoutRng(seed, "cpu"))
        loss = o["lm"] + o["img"] + o["nsp"]
        grads = torch.autograd.grad(loss, [p for p in model.parameters()
                                           if p.requires_grad],
                                    allow_unused=True)
        return float(loss), grads

    l1, g1 = run(7)
    l2, g2 = run(7)
    l3, _ = run(8)
    assert np.isfinite(l1) and l1 == l2 and l3 != l1
    for a, b_ in zip(g1, g2):
        assert (a is None and b_ is None) or torch.equal(a, b_)
    eval_loss = tu.forward_train(model, ct, b, dtype=torch.float32,
                                 train=False)
    assert float(sum(eval_loss.values())) != l1
