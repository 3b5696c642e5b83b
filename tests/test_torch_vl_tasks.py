"""The VL task heads (``unimm_torch/models/vl_tasks.py``) against the JAX
package's ``models/vl_tasks.py`` on the same weights and numpy inputs
(TINY config, CPU, fp32): the seven outputs, the gradients of the heads
and the encoder at dropout 0, the weights carried both ways (the pytree
through ``state_dict_from_jax``, a reference-format dict through the
strict loader), the task dropout's own masks, compact image storage, the
in_batch_pairs refusal, and the heads' mp layout."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_common import TINY, TINY_T, jax_params
from tests.test_model import make_batch
from tests.test_torch_train import NO_DROP, to_jax, to_torch, torch_tree
from unimm_torch import checkpoint as tck
from unimm_torch.models import vilbert as tv
from unimm_torch.models import vl_tasks as tvl
from unimm_torch.parallel import mesh as tmesh
from unimm_tpu import checkpoint as jck
from unimm_tpu.models import vl_tasks as jvl
from unimm_tpu.parallel import mesh as jmesh

RTOL, ATOL = 2e-4, 2e-5           # the port's bar against the JAX package
LABELS = 7
OUTPUTS = ("vil_prediction", "vil_logit", "nsp_logits", "img_logits",
           "vision_logit", "mlm_logits", "linguistic_logit")
HEAD_NAMES = {
    "task_heads.vil_prediction.0.weight_v": (TINY.bi_hidden_size,
                                             2 * TINY.bi_hidden_size),
    "task_heads.vil_prediction.0.weight_g": (),
    "task_heads.vil_prediction.0.bias": (2 * TINY.bi_hidden_size,),
    "task_heads.vil_prediction.3.weight_v": (2 * TINY.bi_hidden_size,
                                             LABELS),
    "task_heads.vil_prediction.3.weight_g": (),
    "task_heads.vil_prediction.3.bias": (LABELS,),
    "task_heads.vil_logit.weight": (1, TINY.bi_hidden_size),
    "task_heads.vil_logit.bias": (1,),
    "task_heads.vision_logit.weight": (1, TINY.v_hidden_size),
    "task_heads.vision_logit.bias": (1,),
    "task_heads.linguisic_logit.weight": (1, TINY.hidden_size),
    "task_heads.linguisic_logit.bias": (1,),
}


@functools.lru_cache(maxsize=None)
def jax_tree():
    """The JAX TINY parameters with task heads (std 0.2 on the heads, so
    that their outputs are far from zero)."""
    return dict(jax_params(), task_heads=jvl.init_task_heads(
        jax.random.PRNGKey(1), TINY.replace(initializer_range=0.2),
        num_labels=LABELS))


def heads_model(cfg=TINY_T):
    """The port's fp32 CPU model with task heads, carrying ``jax_tree``."""
    model = tvl.add_task_heads(tv.empty_model(cfg, "cpu"), cfg, LABELS)
    model.load_state_dict(tck.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_tree())), strict=True)
    return model


def vl_batch(seed, B=2):
    rng = np.random.default_rng(seed)
    b = {k: np.array(v) for k, v in make_batch(rng, TINY, B=B).items()}
    b["mode"][0] = 0                       # one dis row, one gen row
    b["ans_len"][0] = 0
    b["image_mask"][B - 1, 1] = 0
    return b


@pytest.mark.parametrize("fusion,mode", [("mul", None), ("sum", None),
                                         ("mul", "fast_mode")])
def test_vl_tasks_forward_matches_jax(fusion, mode):
    kw = {"fusion_method": fusion, **({mode: True} if mode else {})}
    cj, ct = TINY.replace(**kw), TINY_T.replace(**kw)
    b = vl_batch(0, B=3)
    if mode == "fast_mode":
        b.update({k: b[k][1:2] for k in ("tokens", "segments", "mode",
                                         "ctx_end", "ans_len")})
    got = tvl.vl_tasks_forward(heads_model(ct), ct, to_torch(b),
                               dtype=torch.float32)
    want = jax.jit(lambda p, x: jvl.vl_tasks_forward(
        p, cj, x, dtype=jnp.float32))(jax_tree(), to_jax(b))
    for name, g, w in zip(OUTPUTS, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert float(got[4][2, 1, 0]) < -5000          # a padded region


@pytest.mark.parametrize("train", [False, True])
def test_vl_tasks_gradients_match_jax(train):
    """The gradient of a fixed random linear functional of the outputs
    with respect to every parameter against jax.grad: with the dropouts
    off (train=False) over all seven outputs, the heads' ``weight_v`` and
    ``weight_g`` included; in training at dropout 0 over all but
    ``vil_prediction``, whose classifier keeps the reference's fixed 0.5
    dropout (each package draws its own mask)."""
    cj, ct = TINY.replace(**NO_DROP), TINY_T.replace(**NO_DROP)
    b = vl_batch(1)
    shapes = [w.shape for w in jax.eval_shape(
        lambda p, x: jvl.vl_tasks_forward(p, cj, x), jax_tree(), to_jax(b))]
    rng = np.random.default_rng(5)
    cots = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if train:
        cots[0] = np.zeros_like(cots[0])

    def jloss(p):
        out = jvl.vl_tasks_forward(p, cj, to_jax(b), train=train,
                                   rng=jax.random.PRNGKey(0),
                                   dtype=jnp.float32, dropout_prob=0.0)
        return sum(jnp.sum(o * c) for o, c in zip(out, cots))

    jl, jg = jax.value_and_grad(jloss)(jax_tree())
    model = heads_model(ct).train(train).requires_grad_(True)
    out = tvl.vl_tasks_forward(model, ct, to_torch(b), train=train,
                               rng=tv.DropoutRng(0, "cpu"),
                               dtype=torch.float32, dropout_prob=0.0)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cots))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    want = torch_tree(jg)
    assert set(HEAD_NAMES) <= set(want)
    for name, p in model.named_parameters():
        got = (p.grad.numpy() if p.grad is not None
               else np.zeros(p.shape, np.float32))
        np.testing.assert_allclose(got, want[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    g3 = model.task_heads.vil_prediction.get_submodule("3").weight_g.grad
    assert (float(g3) != 0.0) == (not train)


def test_state_dict_from_jax_carries_the_heads():
    """The JAX tree with ``task_heads`` loads strictly into a model with
    ``add_task_heads``: the names above, ``weight_v`` [in, out] as JAX
    holds it and ``weight_g`` 0-d; a model without heads keeps the
    reference keys."""
    sd = tck.state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jax_tree()))
    heads = {k: tuple(v.shape) for k, v in sd.items()
             if k.startswith("task_heads.")}
    assert heads == HEAD_NAMES
    model = heads_model()
    assert {n: tuple(p.shape) for n, p in model.named_parameters()
            if n.startswith("task_heads.")} == HEAD_NAMES
    th = jax_tree()["task_heads"]
    v3 = model.task_heads.vil_prediction.get_submodule("3")
    np.testing.assert_array_equal(v3.weight_v.detach().numpy(),
                                  np.asarray(th["vil_prediction"]["3"]
                                             ["weight_v"]))
    assert float(v3.weight_g) == float(th["vil_prediction"]["3"]["weight_g"])
    bare = tv.empty_model(TINY_T, "cpu")
    assert not any(k.startswith("task_heads.") for k in bare.state_dict())
    with pytest.raises(RuntimeError):
        bare.load_state_dict(sd, strict=True)


def test_init_task_heads_follows_the_jax_rules():
    """Each weight-normed linear starts at w = v (``weight_g`` = ||v||_F,
    as JAX's ``init_task_heads``), weights at the config's std, biases
    zero; a seed and a generator seeded alike give the same heads."""
    cfg = TINY_T.replace(initializer_range=0.2)
    heads = tvl.init_task_heads(cfg, LABELS, 3, "cpu")
    again = tvl.init_task_heads(cfg, LABELS,
                                torch.Generator().manual_seed(3))
    for (name, p), (_, q) in zip(heads.named_parameters(),
                                 again.named_parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
    for key in ("0", "3"):
        wn = heads.vil_prediction.get_submodule(key)
        assert torch.equal(wn.weight_g, torch.linalg.vector_norm(wn.weight_v))
        x = torch.randn(4, wn.weight_v.shape[0])
        torch.testing.assert_close(tvl.weight_norm_linear(wn, x),
                                   x @ wn.weight_v)
    w = heads.vil_prediction.get_submodule("3").weight_v
    assert 0.15 < float(w.detach().std()) < 0.25


def test_reference_dict_from_jax_loads_strictly():
    """JAX's ``to_torch_state_dict`` (prefix, tied decoder, untransposed
    ``weight_v``) goes through the port's strict and lenient loaders."""
    ref = jck.to_torch_state_dict(jax_tree())
    strict = tck.load_reference_state_dict(
        tvl.add_task_heads(tv.empty_model(TINY_T, "cpu"), TINY_T, LABELS,
                           seed=3), ref)
    want = heads_model().state_dict()
    for name, t in strict.state_dict().items():
        assert torch.equal(t, want[name]), name
    lenient, n, skipped = tck.load_reference_state_dict_lenient(
        tvl.add_task_heads(tv.init_model(TINY_T, 4, "cpu"), TINY_T, LABELS,
                           seed=3), ref)
    assert skipped == [] and n == len(want)
    for name, t in lenient.state_dict().items():
        assert torch.equal(t, want[name]), name


def test_task_dropout_masks_differ_from_the_heads(monkeypatch):
    """In training the task heads' pooled-dropout mask is drawn after the
    NSP head's from the same DropoutRng: the two [B, bi] masks differ
    (the same rate on both, so only the stream could make them equal)."""
    masks = []
    draw = tv.dropout_scale_mask

    def record(rng, shape, rate, dtype=torch.float32):
        m = draw(rng, shape, rate, dtype)
        masks.append(m)
        return m

    monkeypatch.setattr(tv, "dropout_scale_mask", record)
    ct = TINY_T.replace(head_dropout_prob=0.1)
    b = to_torch(vl_batch(2, B=4))
    model = heads_model(ct).train().requires_grad_(True)
    tvl.vl_tasks_forward(model, ct, b, train=True,
                         rng=tv.DropoutRng(3, "cpu"), dropout_prob=0.1)
    pooled = [m for m in masks if tuple(m.shape) == (4, ct.bi_hidden_size)]
    assert len(pooled) == 2
    assert not torch.equal(pooled[0], pooled[1])


def test_compact_images_give_the_expanded_outputs():
    """A batch with compact ``img_index`` storage (its image_mask read after
    ``expand_images``) gives the outputs of the expanded batch."""
    b = vl_batch(3, B=4)
    idx = np.array([1, 0, 1, 1])
    compact = dict(b, img_index=idx,
                   **{k: b[k][:2] for k in ("image_feat", "image_loc",
                                           "image_mask")})
    expanded = dict(b, **{k: b[k][:2][idx] for k in (
        "image_feat", "image_loc", "image_mask")})
    model = heads_model()
    got = tvl.vl_tasks_forward(model, TINY_T, to_torch(compact))
    want = tvl.vl_tasks_forward(model, TINY_T, to_torch(expanded))
    for name, g, w in zip(OUTPUTS, got, want):
        assert torch.equal(g, w), name


def test_in_batch_pairs_refused():
    ct = TINY_T.replace(in_batch_pairs=True)
    with pytest.raises(ValueError, match="in_batch_pairs"):
        tvl.vl_tasks_forward(heads_model(ct), ct, to_torch(vl_batch(4, B=3)))


def test_heads_are_replicated_by_the_mp_layout():
    """``mesh.jax_paths`` maps the heads to their JAX paths, and, as the
    JAX package's ``param_spec`` replicates every task-head leaf,
    ``layout_dims`` shards none of them."""
    model = heads_model()
    paths = tmesh.jax_paths(model)
    assert paths["task_heads.vil_logit.weight"] == (
        "task_heads", "vil_logit", "kernel")
    assert paths["task_heads.vil_prediction.0.weight_v"] == (
        "task_heads", "vil_prediction", "0", "weight_v")
    for name, path in paths.items():
        if name.startswith("task_heads."):
            assert tuple(jmesh.param_spec(path)) == ()
            assert tmesh.param_spec(path) == ()
    dims = tmesh.layout_dims(model, 2)
    assert dims and not any(n.startswith("task_heads.") for n in dims)
    assert dims == tmesh.layout_dims(tv.empty_model(TINY_T, "cpu"), 2)
