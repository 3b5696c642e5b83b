"""The port's lenient reference-checkpoint load
(``checkpoint.load_reference_state_dict_lenient``) against the JAX
package's ``from_torch_state_dict`` on the same reference-format state dict
(TINY config, CPU): the same parameters array for array, the same
transferred count and skipped keys, and a shape mismatch refused by both.
The strict loader keeps its own tests (tests/test_torch_model.py)."""

import numpy as np
import pytest
import torch

import jax

from tests._torch_common import TINY, TINY_T, jax_params_np
from unimm_torch import checkpoint as tck
from unimm_torch.models import vilbert as tv
from unimm_tpu import checkpoint as jck
from unimm_tpu.models import vilbert as jv

PREFIX = "module.bert_pretrained."
DROPPED = "bert.encoder.layer.1.attention.output.dense.weight"
STRAY = PREFIX + "bert.extra_head.dense.weight"


def _checkpoint():
    """A reference .ckpt ``model_state_dict`` of another init (seed 5):
    wrapper prefixes, legacy LayerNorm gamma / beta, the tied decoder; one
    key dropped and one stray key added."""
    other = jv.init_params(jax.random.PRNGKey(5), TINY)
    ref = {(PREFIX + k[len("bert_pretrained."):])
           .replace("LayerNorm.weight", "LayerNorm.gamma")
           .replace("LayerNorm.bias", "LayerNorm.beta"): v
           for k, v in jck.to_torch_state_dict(other).items()}
    del ref[PREFIX + DROPPED]
    ref[STRAY] = np.ones((3, 4), np.float32)
    return ref


def _template_model():
    """The port's model on the template both loaders start from."""
    model = tv.empty_model(TINY_T, "cpu")
    model.load_state_dict(tck.state_dict_from_jax(jax_params_np()),
                          strict=True)
    return model


def test_lenient_load_matches_jax():
    ref = _checkpoint()
    assert PREFIX + tck.TIED_DECODER in ref
    params, n_jax, skipped_jax = jck.from_torch_state_dict(jax_params_np(),
                                                           ref)
    model, n_torch, skipped_torch = tck.load_reference_state_dict_lenient(
        _template_model(), ref)
    assert n_torch == n_jax == len(ref) - 2      # the stray and tied keys
    assert skipped_torch == skipped_jax == [STRAY]
    want = tck.state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          params))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    # the dropped key kept the template's value; a loaded one took the
    # checkpoint's
    template = tck.state_dict_from_jax(jax_params_np())
    np.testing.assert_array_equal(got[DROPPED].numpy(),
                                  template[DROPPED].numpy())
    key = "bert.encoder.layer.0.attention.self.query.weight"
    np.testing.assert_array_equal(got[key].numpy(), ref[PREFIX + key])
    assert not np.array_equal(got[key].numpy(), template[key].numpy())


def test_lenient_load_refuses_a_shape_mismatch():
    ref = _checkpoint()
    key = PREFIX + "bert.encoder.layer.0.attention.self.query.weight"
    ref[key] = ref[key][:, :-1]
    with pytest.raises(ValueError, match="shape mismatch"):
        jck.from_torch_state_dict(jax_params_np(), ref)
    model = _template_model()
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.load_reference_state_dict_lenient(model, ref)
    # nothing was loaded
    for k, v in tck.state_dict_from_jax(jax_params_np()).items():
        assert torch.equal(model.state_dict()[k], v), k
