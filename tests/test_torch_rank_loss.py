"""The port's ranking losses (``unimm_torch.ops.rank_loss``) and focal /
gradient-harmonizing losses (``ops.focal_losses``) against the JAX
package's on seeded numpy inputs: values and gradients (``jax.grad``
against autograd), with padded list entries (relevance -1). The JAX
package's own tests of these use the absent torch reference as their
oracle; here JAX is the oracle. The stochastic sort is compared on the
same Gumbel draws (JAX's, passed to the port as ``gumbel``). Tolerance:
rtol 1e-5, atol 1e-6 (fp32; the two packages sum in different orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unimm_torch.ops import focal_losses as tfl
from unimm_torch.ops import rank_loss as trl
from unimm_tpu.ops import focal_losses as jfl
from unimm_tpu.ops import rank_loss as jrl

RTOL, ATOL = 1e-5, 1e-6


def _slates(seed, B=3, n=12, pad=(0, 3, 5)):
    """Scores [B, n] and graded relevances in {0, 0.25, ..., 1} with the
    last ``pad[b]`` entries of row b padded (-1)."""
    rng = np.random.default_rng(seed)
    y_pred = rng.normal(size=(B, n)).astype(np.float32)
    y_true = rng.choice([0.0, 0.25, 0.5, 0.75, 1.0], (B, n)).astype(
        np.float32)
    for b, p in enumerate(pad[:B]):
        if p:
            y_true[b, -p:] = -1.0
    return y_pred, y_true


def _close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _value_and_grad(t_fn, j_fn, *args):
    """(torch value, torch grad, jax value, jax grad) in the first
    argument."""
    x = torch.from_numpy(args[0].copy()).requires_grad_(True)
    rest = [torch.from_numpy(a.copy()) for a in args[1:]]
    v = t_fn(x, *rest)
    v.backward()
    jv, jg = jax.value_and_grad(lambda a: j_fn(a, *map(jnp.asarray,
                                                       args[1:])))(
        jnp.asarray(args[0]))
    return v.detach().numpy(), x.grad.numpy(), np.asarray(jv), \
        np.asarray(jg)


RANK_CASES = {   # case -> (function, keywords)
    "neuralNDCG_transposed": ("neuralNDCG_transposed", {}),
    "neuralNDCG_transposed_k5_t2": ("neuralNDCG_transposed",
                                    dict(k=5, temperature=2.0)),
    "neuralNDCG_transposed_linear": ("neuralNDCG_transposed",
                                     dict(powered_relevancies=False)),
    "neuralNDCG": ("neuralNDCG", {}),
    "neuralNDCG_k4": ("neuralNDCG", dict(k=4)),
    "listNet": ("listNet", {}),
    "listMLE": ("listMLE", {}),
    "rankNet": ("rankNet", {}),
    "rankNet_diff": ("rankNet", dict(weight_by_diff=True)),
    "rankNet_diff_powed": ("rankNet", dict(weight_by_diff_powed=True)),
    "approxNDCGLoss": ("approxNDCGLoss", {}),
    "lambdaLoss": ("lambdaLoss", {}),
    "lambdaLoss_k5_sum": ("lambdaLoss", dict(k=5, reduction="sum")),
    "lambdaLoss_natural_log": ("lambdaLoss", dict(reduction_log="natural")),
}
RANK_CASES.update({f"lambdaLoss_{s}": ("lambdaLoss",
                                       dict(weighing_scheme=s))
                   for s in jrl._SCHEMES})


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_rank_loss_matches_jax(case):
    name, kw = RANK_CASES[case]
    y_pred, y_true = _slates(list(RANK_CASES).index(case))
    v, g, jv_, jg = _value_and_grad(
        lambda a, b: getattr(trl, name)(a, b, **kw),
        lambda a, b: getattr(jrl, name)(a, b, **kw), y_pred, y_true)
    assert np.isfinite(v) and np.isfinite(g).all()
    _close(v, jv_, f"{case} value")
    _close(g, jg, f"{case} grad")


def test_dense_step_ranking_matches_jax():
    """The dense finetuning's use: NSP probabilities of a 100-option slate
    against graded relevance, no padding."""
    rng = np.random.default_rng(5)
    probs = rng.uniform(0, 1, (1, 100)).astype(np.float32)
    rel = rng.choice([0.0, 0.5, 1.0], (1, 100)).astype(np.float32)
    v, g, jv_, jg = _value_and_grad(trl.neuralNDCG_transposed,
                                    jrl.neuralNDCG_transposed, probs, rel)
    _close(v, jv_, "value")
    _close(g, jg, "grad")


@pytest.mark.parametrize("fn", ["neuralNDCG_transposed", "neuralNDCG"])
def test_stochastic_sort_matches_jax_on_the_same_draws(fn):
    y_pred, y_true = _slates(7)
    y_pred = np.abs(y_pred) + 0.1
    key = jax.random.PRNGKey(3)
    S, (B, n) = 4, y_pred.shape
    gumbel = np.asarray(jrl.sample_gumbel(key, (S, B, n, 1)))
    v, g, jv_, jg = _value_and_grad(
        lambda a, b: getattr(trl, fn)(a, b, stochastic=True, n_samples=S,
                                      gumbel=torch.from_numpy(gumbel)),
        lambda a, b: getattr(jrl, fn)(a, b, stochastic=True, n_samples=S,
                                      rng=key), y_pred, y_true)
    _close(v, jv_, "value")
    _close(g, jg, "grad")
    # the generator path draws its own noise: same shape, finite
    gen = torch.Generator().manual_seed(0)
    out = trl.stochastic_neural_sort(torch.from_numpy(y_pred)[..., None], S,
                                     1.0, torch.from_numpy(y_true) == -1,
                                     generator=gen)
    assert out.shape == (S, B, n, n) and torch.isfinite(out).all()


def test_dcg_and_sinkhorn_match_jax():
    y_pred, y_true = _slates(9)
    _close(trl.dcg(torch.from_numpy(y_pred), torch.from_numpy(y_true),
                   ats=[1, 5, 20]).numpy(),
           jrl.dcg(jnp.asarray(y_pred), jnp.asarray(y_true), ats=[1, 5, 20]),
           "dcg")
    mat = np.random.default_rng(1).uniform(0.1, 1, (3, 12, 12)).astype(
        np.float32)
    mask = y_true == -1
    _close(trl.sinkhorn_scaling(torch.from_numpy(mat),
                                torch.from_numpy(mask)).numpy(),
           jrl.sinkhorn_scaling(jnp.asarray(mat), jnp.asarray(mask)),
           "sinkhorn")


def test_list_mle_generator_shuffles():
    y_pred, y_true = _slates(2)
    a = trl.listMLE(torch.from_numpy(y_pred), torch.from_numpy(y_true),
                    generator=torch.Generator().manual_seed(4))
    b = trl.listMLE(torch.from_numpy(y_pred), torch.from_numpy(y_true))
    assert torch.isfinite(a) and torch.isfinite(b)


FOCAL_CASES = {   # case -> (function, input kind, keywords)
    "binary_ce_focal_loss": ("binary_ce_focal_loss", "bin", {}),
    "binary_ce_focal_loss_sum": ("binary_ce_focal_loss", "bin",
                                 dict(reduction="sum")),
    "binary_ce_focal_loss_none": ("binary_ce_focal_loss", "bin",
                                  dict(reduction="none")),
    "multi_ce_focal_loss": ("multi_ce_focal_loss", "multi", {}),
    "multi_ce_focal_loss_alpha": ("multi_ce_focal_loss", "multi",
                                  dict(alpha=[0.25, 0.75], gamma=1.5)),
    "ghmc_loss": ("ghmc_loss", "bin", {}),
    "ghmr_loss": ("ghmr_loss", "bin", {}),
    "dense_qfocal_log": ("dense_qfocal_log", "dense", {}),
    "dense_ce_log": ("dense_ce_log", "dense", {}),
}


@pytest.mark.parametrize("case", list(FOCAL_CASES))
def test_focal_loss_matches_jax(case):
    name, kind, kw = FOCAL_CASES[case]
    rng = np.random.default_rng(list(FOCAL_CASES).index(case))
    if kind == "bin":
        x = rng.normal(size=(6, 5)).astype(np.float32) * 2
        target = rng.integers(0, 2, (6, 5)).astype(np.float32)
    elif kind == "multi":
        x = rng.normal(size=(8, 2)).astype(np.float32) * 2
        target = rng.integers(0, 2, 8).astype(np.int64)
    else:
        x = rng.normal(size=(2, 100, 2)).astype(np.float32)
        target = rng.choice([0.0, 0.5, 1.0], (2, 100)).astype(np.float32)

    def t_fn(a, b):
        out = getattr(tfl, name)(a, b, **kw)
        return out[0] if isinstance(out, tuple) else out

    def j_fn(a, b):
        out = getattr(jfl, name)(a, b, **kw)
        return out[0] if isinstance(out, tuple) else out

    if kw.get("reduction") == "none":
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        v = t_fn(xt, torch.from_numpy(target))
        v.sum().backward()
        jv_, jg = jax.value_and_grad(
            lambda a: j_fn(a, jnp.asarray(target)).sum())(jnp.asarray(x))
        _close(v.detach().numpy().sum(), jv_, "value")
        _close(xt.grad.numpy(), jg, "grad")
        return
    v, g, jv_, jg = _value_and_grad(t_fn, j_fn, x, target)
    _close(v, jv_, f"{case} value")
    _close(g, jg, f"{case} grad")


@pytest.mark.parametrize("name", ["ghmc_loss", "ghmr_loss"])
def test_ghm_bin_counts_carry_as_jax(name):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    target = rng.integers(0, 2, (6, 5)).astype(np.float32)
    lt, ct = getattr(tfl, name)(torch.from_numpy(x), torch.from_numpy(
        target))
    lj, cj = getattr(jfl, name)(jnp.asarray(x), jnp.asarray(target))
    _close(ct.numpy(), cj, "first counts")
    lt2, ct2 = getattr(tfl, name)(torch.from_numpy(x * 0.5),
                                  torch.from_numpy(target),
                                  last_bin_count=ct)
    lj2, cj2 = getattr(jfl, name)(jnp.asarray(x * 0.5), jnp.asarray(target),
                                  last_bin_count=cj)
    _close(ct2.numpy(), cj2, "EMA counts")
    _close(float(lt2), float(lj2), "loss")
