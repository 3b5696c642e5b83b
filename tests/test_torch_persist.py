"""The port's training persistence against the JAX package's, on the TINY
config's parameters (CPU, fp32):

* the optimizer's two counters: restored apart (the Adam count from the
  file's ``step``, the schedule count from ``iter_id // batch_multiply``),
  the next update equals JAX's from its ``_graft_opt_state`` state on the
  same gradients;
* a reference ``.ckpt`` read across the packages in both directions gives
  the moments and counters bit for bit (a ``-adam_mu_dtype bfloat16``
  moment keeps its dtype), and the port writes JAX's keys in JAX's order;
* a native save and restore gives back every tensor and counter bit for
  bit, halfway through an accumulation too; a killed save's temporary
  directory is never taken for a step; the eval CLIs load a native
  directory's weights.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests._torch_common import TINY_T, jax_params, jax_params_np, \
    torch_model
from tests.test_torch_train import LANG
from unimm_torch import checkpoint as tck
from unimm_torch.cli import common as t_common
from unimm_torch.models import vilbert as tv
from unimm_torch.train import optim as topt
from unimm_torch.train import step as tstep
from unimm_tpu import checkpoint as jck
from unimm_tpu.train import optim as jopt

OCFG = dict(lr=1e-3, image_lr=5e-4, warmup_steps=4, t_total=50)


def _grads(seed):
    """Seeded gradients: (JAX pytree, the port's list in parameter
    order)."""
    rng = np.random.default_rng(seed)
    g = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        jax_params_np())
    sd = tck.state_dict_from_jax(g)
    return jax.tree_util.tree_map(jnp.asarray, g), sd


def _port(fused=False, k=1, mu_dtype=None):
    model = torch_model().train().requires_grad_(True)
    make = topt.make_fused_optimizer if fused else topt.make_optimizer
    return model, make(model, topt.OptimConfig(
        batch_multiply=k, mu_dtype=mu_dtype, **OCFG), LANG)


def _jax_tx(fused=False, k=1, mu_dtype=None):
    make = jopt.make_fused_optimizer if fused else jopt.make_optimizer
    return make(jax_params(), jopt.OptimConfig(
        batch_multiply=k, mu_dtype=mu_dtype, **OCFG), LANG)


def _adam_sched(opt_state):
    """JAX's (ScaleByAdamState, schedule count, MultiSteps mini_step)."""
    mini = None
    if isinstance(opt_state, optax.MultiStepsState):
        mini = int(opt_state.mini_step)
        opt_state = opt_state.inner_opt_state
    adam, sched = opt_state
    return adam, int(sched.count), mini


def _jax_moments(adam):
    """JAX's moments as {reference name: torch-layout numpy} (dtype
    kept)."""
    out = {}
    for kind, tree in (("mu", adam.mu), ("nu", adam.nu)):
        for path, leaf in jck.iter_param_items(tree):
            a = np.asarray(leaf)
            out[kind, jck.torch_name(path)] = a.T if path[-1] == "kernel" \
                else a
    return out


def _assert_moments_bit_equal(opt, adam):
    want = _jax_moments(adam)
    for kind, moms in (("mu", opt.mu), ("nu", opt.nu)):
        for name, m in zip(opt.names, moms):
            w = want[kind, name]
            got = m.detach()
            assert str(got.dtype).endswith(str(w.dtype)), (name, got.dtype,
                                                           w.dtype)
            np.testing.assert_array_equal(got.float().numpy(),
                                          w.astype(np.float32),
                                          err_msg=f"{kind} {name}")


def _jax_ckpt(path, iter_id, fused=False, k=1, mu_dtype=None, updates=2):
    """JAX's .ckpt after ``updates`` updates of seeded gradients."""
    tx = _jax_tx(fused, k, mu_dtype)
    p = jax_params()
    s = tx.init(p)
    for i in range(updates * k):
        u, s = tx.update(_grads(100 + i)[0], s, p)
        p = jax.tree_util.tree_map(lambda a, b: a + b, p, u)
    jck.save_reference_ckpt(path, p, iter_id, opt_state=s,
                            lang_set=jck.language_param_set(LANG))
    return tx


@pytest.mark.parametrize("fused,k,mu_dtype", [
    (False, 1, None), (True, 1, None), (False, 2, None),
    (False, 1, "bfloat16")])
def test_jax_ckpt_loads_into_port_bit_for_bit(tmp_path, fused, k, mu_dtype):
    """JAX's .ckpt (Adam count 2, 1 for the fused optimizer, whose
    interpreted updates are slow; iter_id 7: schedule 7 // k) read by both
    packages: the same moments and counters; then one update from the same
    gradients agrees (the optimizer tests' tolerance)."""
    path = str(tmp_path / "jax.ckpt")
    updates = 1 if fused else 2
    tx = _jax_ckpt(path, 7, fused, k, mu_dtype, updates=updates)
    jp, js, iter_j, n_j = jck.load_reference_train_state(
        path, jax_params(), tx, batch_multiply=k)
    adam, sched, mini = _adam_sched(js)
    model, opt = _port(fused, k, mu_dtype)
    _, _, iter_t, n_t = tck.load_reference_train_state(path, model, opt,
                                                       batch_multiply=k)
    assert (iter_t, n_t) == (iter_j, n_j) == (7, len(opt.names))
    assert (opt.count, opt.sched_count) == (int(adam.count), sched) == (
        updates, 7 // k)
    assert opt.mini_step == (mini or 0) and opt.acc is None
    _assert_moments_bit_equal(opt, adam)
    sd = model.state_dict()
    for path_, leaf in jck.iter_param_items(jp):
        a = np.asarray(leaf)
        np.testing.assert_array_equal(
            sd[jck.torch_name(path_)].numpy(),
            a.T if path_[-1] == "kernel" else a)

    # the next update, from the two counters restored apart
    for i in range(k):
        gj, gt = _grads(200 + i)
        u, js = tx.update(gj, js, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, u)
        opt.step([gt[nm] for nm in opt.names])
    adam, sched, _ = _adam_sched(js)
    assert (opt.count, opt.sched_count) == (int(adam.count), sched) == (
        updates + 1, 7 // k + 1)
    want = tck.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    for name, p in model.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("fused,mu_dtype", [(False, None), (True, None),
                                            (False, "bfloat16")])
def test_port_ckpt_loads_into_jax_bit_for_bit(tmp_path, fused, mu_dtype):
    """The port's .ckpt (its keys in JAX's order) read by JAX: the port's
    own moments and counters, and the port's own weights."""
    model, opt = _port(fused, 1, mu_dtype)
    for i in range(2):
        opt.step([_grads(300 + i)[1][nm] for nm in opt.names])
    path = str(tmp_path / "port.ckpt")
    tck.save_reference_ckpt(path, model, 9, opt=opt,
                            lang_set=tck.language_param_set(LANG),
                            lr=1e-3, image_lr=5e-4)
    blob = torch.load(path, weights_only=False)
    want_keys = list(jck.to_torch_state_dict(jax_params_np()))
    assert list(blob["model_state_dict"]) == want_keys
    assert blob["scheduler_state_dict"]["last_epoch"] == 9
    tx = _jax_tx(fused, 1, mu_dtype)
    jp, js, iter_j, _ = jck.load_reference_train_state(
        path, jax_params(), tx, batch_multiply=3)
    adam, sched, _ = _adam_sched(js)
    assert (iter_j, int(adam.count), sched) == (9, opt.count, 9 // 3)
    _assert_moments_bit_equal(opt, adam)
    sd = model.state_dict()
    for path_, leaf in jck.iter_param_items(jp):
        a = np.asarray(leaf)
        np.testing.assert_array_equal(
            sd[jck.torch_name(path_)].detach().numpy(),
            a.T if path_[-1] == "kernel" else a)
    # and the port's own reader gives its state back
    model2, opt2 = _port(fused, 1, mu_dtype)
    tck.load_reference_train_state(path, model2, opt2)
    for a, b in zip(opt.mu + opt.nu, opt2.mu + opt2.nu):
        assert torch.equal(a, b)


def _state(seed, fused=False, k=2, mu_dtype=None):
    model = tv.init_model(TINY_T, seed=seed, device="cpu")
    model.train().requires_grad_(True)
    make = topt.make_fused_optimizer if fused else topt.make_optimizer
    opt = make(model, topt.OptimConfig(batch_multiply=k, mu_dtype=mu_dtype,
                                       **OCFG), LANG)
    return tstep.init_state(model, opt, seed=seed)


@pytest.mark.parametrize("fused,mu_dtype", [(False, None), (True, None),
                                            (False, "bfloat16")])
def test_native_roundtrip_mid_accumulation(tmp_path, fused, mu_dtype):
    state = _state(3, fused, 2, mu_dtype)
    opt = state["opt"]
    for i in range(3):               # one update, then one micro-step
        opt.step([_grads(400 + i)[1][nm] for nm in opt.names])
    state["step"] = 3
    opt.sched_count = 11             # the counters apart
    assert opt.mini_step == 1 and opt.acc is not None
    path = tck.save_native(str(tmp_path / "native"), state, 3)
    assert os.path.basename(path) == "step_3"
    back = tck.restore_native(path, _state(5, fused, 2, mu_dtype))
    assert (back["step"], back["seed"]) == (3, 3)
    bo = back["opt"]
    assert (bo.count, bo.sched_count, bo.mini_step) == (1, 11, 1)
    for a, b in zip(list(state["model"].parameters()) + opt.mu + opt.nu
                    + opt.acc, list(back["model"].parameters()) + bo.mu
                    + bo.nu + bo.acc):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the restored optimizer finishes the accumulation as the original
    g = [_grads(500)[1][nm] for nm in opt.names]
    opt.step([x.clone() for x in g])
    bo.step([x.clone() for x in g])
    for a, b in zip(state["model"].parameters(), back["model"].parameters()):
        assert torch.equal(a, b)


def test_latest_native_skips_a_killed_save(tmp_path):
    d = tmp_path / "native"
    state = _state(1)
    tck.save_native(str(d), state, 4)
    (d / ".tmp_step_9_123").mkdir()      # a save killed before its rename
    assert tck.latest_native(str(d)) == (str(d / "step_4"), 4)
    tck.save_native(str(d), state, 4)    # replaces the step in place
    assert sorted(os.listdir(d)) == [".tmp_step_9_123", "step_4"]


def test_eval_cli_loads_a_native_directory(tmp_path):
    state = _state(2)
    state["step"] = 6
    tck.save_native(str(tmp_path / "native"), state, 6)
    for path in (tmp_path / "native", tmp_path / "native" / "step_6"):
        model = t_common.load_any_checkpoint(
            str(path), tv.init_model(TINY_T, seed=9, device="cpu"))
        for a, b in zip(state["model"].parameters(), model.parameters()):
            assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        t_common.load_any_checkpoint(str(tmp_path),
                                     tv.init_model(TINY_T, device="cpu"))
