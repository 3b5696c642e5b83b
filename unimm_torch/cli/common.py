"""Shared CLI wiring: config / tokenizer / reader / model / checkpoint setup.

The port's counterpart of the JAX package's ``cli/common.py``. Its
``setup_jax`` (compile cache, ``jax.distributed``) has no counterpart:
``setup_torch`` resolves the device (a CUDA device without a card raises),
joins the world of ``-coordinator_address`` (one process per card,
arranged as dp x ``-mesh_mp``, ``parallel/dist.py``), turns TF32 off (fp32
parity, ROADMAP.md invariants) and seeds. An eval entry point's loader is
this rank's disjoint shard of the split under ``-eval_data_sharded`` in a
world (``eval_sharded``; the metrics are merged by the evaluator's
``process_merge``; every rank holds its model whole and ``-mesh_mp`` has
no effect, as the JAX package's ``local_mesh`` has mp 1), the whole split
otherwise (serving: the dp groups split the rows of every scoring
dispatch and each model is sharded over the mp group, ``serving_model``).
``StepProfiler`` traces a window of training steps with ``torch.profiler``
where the JAX package uses ``jax.profiler``.
"""

from __future__ import annotations

import os
from typing import List

import torch

from unimm_torch import checkpoint as C
from unimm_torch.config import VilbertConfig
from unimm_torch.data import features
from unimm_torch.data.loader import DataLoader
from unimm_torch.data.tokenizer import WordPieceTokenizer
from unimm_torch.models import vilbert
from unimm_torch.parallel import dist, mesh


def setup_torch(params: dict, device=None, backend=None) -> torch.device:
    """The device the entry point runs on (raises when a CUDA device is
    asked for and there is no card): ``device``, else
    ``dist.default_device`` (``cuda``, or ``cuda:<process_id>`` in a world
    that fits the host's cards); joins the world of the flags on it
    (``backend``: nccl on a card, gloo on the CPU by default); TF32 off;
    the torch seed."""
    dev = vilbert.resolve_device(device or dist.default_device(params))
    dist.init_world(params, dev, backend)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(params.get("seed", 0))
    return dev


def build_config(params: dict) -> VilbertConfig:
    cfg = VilbertConfig.from_json_file(params["model_config"])
    return cfg.replace(max_seq_len=params["max_seq_len"],
                       attention_impl=params.get("attention_impl",
                                                 "pallas_block"),
                       remat=bool(params.get("remat", 0)))


def eval_sharded(params: dict) -> bool:
    """Whether this rank scores a disjoint shard of the split
    (``-eval_data_sharded`` in a world of several processes)."""
    return dist.world_size() > 1 and bool(params["eval_data_sharded"])


def serving_model(params: dict, model):
    """An eval entry point's ``model`` as it serves: sharded over the mp
    group (``mesh.shard_model``) unless ``eval_sharded``."""
    return model if eval_sharded(params) else mesh.shard_model(model)


def eval_loader(params: dict, dataset, batch_size: int) -> DataLoader:
    """The eval entry points' loader, in order: this rank's shard of every
    global batch of ``batch_size`` dialogs when ``eval_sharded`` (a tail
    that the world does not divide is padded and masked by ``valid``),
    the whole split otherwise."""
    sharded = eval_sharded(params)
    return DataLoader(dataset, batch_size, shuffle=False,
                      num_workers=params["num_workers"],
                      process_index=dist.rank() if sharded else 0,
                      process_count=dist.world_size() if sharded else 1)


class StepProfiler:
    """Traces steps ``start`` to ``stop`` with ``torch.profiler`` when
    -profile_dir is set (a Chrome trace, ``trace_<start>_<stop>.json``,
    in that directory); without it every call does nothing."""

    def __init__(self, directory: str, start: int = 10, stop: int = 15):
        self.dir = directory
        self.start, self.stop = start, stop
        self._prof = None

    def step(self, i: int):
        if not self.dir:
            return
        if i == self.start and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        elif i >= self.stop and self._prof is not None:
            self._finish()
            print(f"profiler trace written to {self.dir}")

    def _finish(self):
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.dir, f"trace_{self.start}_{self.stop}.json"))

    def close(self):
        if self._prof is not None:
            self._finish()


def load_tokenizer(params: dict) -> WordPieceTokenizer:
    return WordPieceTokenizer.from_vocab_file(params["vocab_path"])


def open_reader(params: dict):
    return features.open_features(params["visdial_image_feats"])


def compute_dtype(params: dict):
    return torch.bfloat16 if params.get("dtype", "bfloat16") == "bfloat16" \
        else torch.float32


def init_model(params: dict, cfg: VilbertConfig, device="cuda"):
    """The seeded init (``vilbert.init_model``, seed ``-seed``) on the
    device, then ``-start_path`` over it."""
    model = vilbert.init_model(cfg, seed=params.get("seed", 0),
                               device=device)
    if params.get("start_path"):
        model = load_any_checkpoint(params["start_path"], model)
    return model


def load_any_checkpoint(path: str, model):
    """Load a reference-format .ckpt (or a local .tar.gz archive of one),
    or the weights of a native checkpoint directory (a ``step_<n>``
    directory or a directory of them: its latest), into ``model``."""
    if os.path.isdir(path):
        model, step = C.load_native_params(path, model)
        print(f"native checkpoint restored at step {step}")
        return model
    model, iter_id, n, skipped = C.load_reference_ckpt(path, model)
    print(f"number of keys transferred {n}"
          + (f" (skipped {len(skipped)})" if skipped else ""))
    assert n > 0
    return model


def load_ensemble(params: dict, cfg: VilbertConfig, device="cuda") -> List:
    """One model per ``-model_paths`` entry (else ``-start_path``), each a
    seed-0 init with its checkpoint over it (the JAX package's template),
    as it serves (``serving_model``)."""
    paths = [p for p in params.get("model_paths", "").split(",") if p]
    if not paths and params.get("start_path"):
        paths = [params["start_path"]]
    assert paths, "provide -model_paths or -start_path"
    return [serving_model(params, load_any_checkpoint(
        p, vilbert.init_model(cfg, seed=0, device=device))) for p in paths]


def print_metrics(metrics: dict):
    for name, value in metrics.items():
        print(f"{name}: {value}")
