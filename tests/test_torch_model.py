"""The PyTorch port's model pieces against the JAX package on the same
weights (TINY config, CPU, fp32): the weight bridge, the descriptor masks,
the encoder and the flat eval scorer, the reference-checkpoint loader and
the ranking metrics."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_common import (TINY, TINY_T, jax_params, jax_params_np,
                                 torch_model)
from tests.test_masks import GEN_CASES
from tests.test_model import make_batch
from unimm_torch import checkpoint as tck
from unimm_torch.models import unimm as tu
from unimm_torch.models import vilbert as tv
from unimm_torch.ops import masks as tm
from unimm_torch.ops import metrics as tmet
from unimm_tpu import checkpoint as jck
from unimm_tpu.models import unimm as ju
from unimm_tpu.ops import masks as jm
from unimm_tpu.ops import metrics as jmet


# --- weight bridge ---------------------------------------------------------

def test_bridge_keys_are_reference_names():
    sd = tck.state_dict_from_jax(jax_params_np())
    ref = jck.to_torch_state_dict(jax_params(), prefix="",
                                  include_tied_decoder=False)
    assert list(sd) == list(ref)
    for k in ("bert.encoder.layer.0.attention.self.query.weight",
              "bert.encoder.c_layer.0.biOutput.q_dense2.weight",
              "cls.predictions.bias"):
        assert k in sd
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    model = tv.empty_model(TINY_T, "cpu")
    assert sorted(model.state_dict()) == sorted(sd)


def test_bridge_strict_load_rejects_missing_and_unexpected():
    sd = tck.state_dict_from_jax(jax_params_np())
    model = tv.empty_model(TINY_T, "cpu")
    model.load_state_dict(sd, strict=True)
    missing = dict(sd)
    missing.pop("bert.t_pooler.dense.weight")
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(missing, strict=True)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        model.load_state_dict({**sd, "bert.extra.weight": torch.zeros(1)},
                              strict=True)


def test_load_reference_state_dict():
    """A reference .ckpt state dict (prefixed keys, legacy gamma/beta, the
    tied decoder) loads strictly; an untied decoder or a stray key raises."""
    ref = jck.to_torch_state_dict(jax_params())   # bert_pretrained. prefix
    ref = {("module." + k).replace("LayerNorm.weight", "LayerNorm.gamma"): v
           for k, v in ref.items()}
    model = tck.load_reference_state_dict(tv.empty_model(TINY_T, "cpu"), ref)
    np.testing.assert_array_equal(
        model.bert.encoder.layer[1].output.LayerNorm.weight.numpy(),
        jax_params_np()["bert"]["encoder"]["layer"]["1"]["output"][
            "LayerNorm"]["weight"])
    bad = dict(ref)
    key = "module.bert_pretrained.cls.predictions.decoder.weight"
    bad[key] = bad[key] + 1.0
    with pytest.raises(ValueError, match="not tied"):
        tck.load_reference_state_dict(tv.empty_model(TINY_T, "cpu"), bad)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        tck.load_reference_state_dict(tv.empty_model(TINY_T, "cpu"),
                                      {**ref, "module.extra": np.zeros(1)})


def test_config_reads_the_reference_json():
    """The shipped reference config file gives the default config, as it
    does for the JAX package's VilbertConfig."""
    from pathlib import Path

    from unimm_torch.config import VilbertConfig
    from unimm_tpu.config import VilbertConfig as JaxConfig
    path = Path(__file__).resolve().parents[1] / "config" / \
        "bert_base_6layer_6conect.json"
    cfg = VilbertConfig.from_json_file(str(path))
    assert cfg == VilbertConfig()
    jcfg = JaxConfig.from_json_file(str(path))
    for f in ("hidden_size", "num_hidden_layers", "v_biattention_id",
              "t_biattention_id", "fusion_method", "vocab_size"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    with pytest.raises(ValueError, match="attention_impl"):
        VilbertConfig(attention_impl="pallas")


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tv.init_model(TINY_T)


def test_init_model_matches_reference_init_rules():
    model = tv.init_model(TINY_T, seed=3, device="cpu")
    w = model.bert.encoder.layer[0].attention.self.query.weight
    assert abs(float(w.std()) - TINY_T.initializer_range) < 5e-3
    assert float(model.bert.encoder.layer[0].output.LayerNorm.weight.min()) \
        == 1.0
    assert float(model.cls.predictions.bias.abs().max()) == 0.0
    again = tv.init_model(TINY_T, seed=3, device="cpu")
    assert torch.equal(w, again.bert.encoder.layer[0].attention.self.query
                       .weight)


# --- masks -----------------------------------------------------------------

@pytest.mark.parametrize("L1,A,max_len", GEN_CASES)
def test_masks_match_jax(L1, A, max_len):
    mode = np.array([1, 0, 1], np.int32)
    ce = np.array([L1, min(L1, max_len), L1], np.int32)
    al = np.array([A, 0, max(1, A - 1)], np.int32)
    for name in ("text_attention_mask", "co_text_mask", "position_ids",
                 "text_self_bias", "co_attention_bias"):
        got = getattr(tm, name)(torch.from_numpy(mode), torch.from_numpy(ce),
                                torch.from_numpy(al), max_len)
        want = getattr(jm, name)(mode, ce, al, max_len)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)


def test_image_bias_and_buckets_match_jax():
    im = np.array([[1, 1, 0, 1], [0, 0, 1, 1]], np.float32)
    np.testing.assert_array_equal(
        tm.image_self_bias(torch.from_numpy(im)).numpy(),
        np.asarray(jm.image_self_bias(im)))
    for ext in (1, 31, 32, 33, 191, 255, 256, 300):
        for div in (4, 8, 3):
            assert tm.quarter_bucket(ext, 256, div) == \
                jm.quarter_bucket(ext, 256, div)


# --- encoder and flat scorer ----------------------------------------------

def _batch(seed):
    b = make_batch(np.random.default_rng(seed), TINY, B=3, gen=True)
    labels = np.full((3, TINY.max_seq_len), -1, np.int32)
    labels[:, 20:25] = np.asarray(b["tokens"])[:, 20:25]
    labels[1, 21] = -1
    b = {**{k: np.array(v) for k, v in b.items()}, "mlm_labels": labels}
    b["segments"][0, 3] = TINY.type_vocab_size + 2   # extension table
    return b


def test_encode_matches_jax():
    b = _batch(0)
    t_seq, v_seq, pt, pv = tu.encode(
        torch_model(), TINY_T, {k: torch.from_numpy(v) for k, v in b.items()},
        dtype=torch.float32)
    jt, jvs, jpt, jpv = jax.jit(lambda p, x: ju.encode(
        p, TINY, x, dtype=jnp.float32))(
        jax_params(), {k: jnp.asarray(v) for k, v in b.items()})
    for got, want in ((t_seq, jt), (v_seq, jvs), (pt, jpt), (pv, jpv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-5)


def test_forward_eval_matches_jax():
    b = _batch(1)
    got = tu.forward_eval(torch_model(), TINY_T,
                          {k: torch.from_numpy(v) for k, v in b.items()},
                          dtype=torch.float32, max_label_positions=8)
    want = jax.jit(lambda p, x: ju.forward_eval(
        p, TINY, x, dtype=jnp.float32, max_label_positions=8))(
        jax_params(), {k: jnp.asarray(v) for k, v in b.items()})
    for k in ("lm_nll_sum", "lm_nll_mean", "nsp_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


def test_label_positions_match_jax():
    rng = np.random.default_rng(4)
    labs = np.where(rng.random((5, 32)) < 0.3,
                    rng.integers(0, 50, (5, 32)), -1).astype(np.int32)
    pos, got = tu.label_positions(torch.from_numpy(labs), 12)
    jpos, want = ju.label_positions(jnp.asarray(labs), 12)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- metrics ---------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    scores = rng.normal(size=(4, 3, 20)).astype(np.float32)
    scores[0, 0, 5] = scores[0, 0, 7]           # a tie: broken by position
    gt = rng.integers(0, 20, (4, 3))
    rel = np.where(rng.random((4, 20)) < 0.4, rng.random((4, 20)),
                   0).astype(np.float32)
    np.testing.assert_array_equal(tmet.scores_to_ranks(scores),
                                  np.asarray(jmet.scores_to_ranks(scores)))
    np.testing.assert_allclose(tmet.ndcg_batch(scores[:, 0], rel),
                               np.asarray(jmet.ndcg_batch(scores[:, 0], rel)),
                               rtol=1e-6)
    ts, js = tmet.SparseGTMetrics(), jmet.SparseGTMetrics()
    tn, jn = tmet.NDCG(), jmet.NDCG()
    for acc in (ts, js):
        acc.observe(scores, gt)
    for acc in (tn, jn):
        acc.observe(scores[:, 1], rel)
    got, want = {**ts.retrieve(), **tn.retrieve()}, {**js.retrieve(),
                                                     **jn.retrieve()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
