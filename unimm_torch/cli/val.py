"""Discriminative (NSP-probability) ensemble evaluation on VisDial val.

The port's counterpart of the JAX package's ``cli/val.py`` (the reference's
val.py): per-model NSP probabilities min-max normalised per candidate slate
and summed across the ensemble (on the card: the attention-block and FFN
kernels). Checkpoints come from -model_paths (comma-separated) instead of
the reference's hard-coded in-source paths (val.py:216-222). In a
data-parallel world the ranks split every chunk's rows, or, with
``-eval_data_sharded 1``, score disjoint shards (``cli/val_lm.py``).
"""

from __future__ import annotations

import sys

from unimm_torch.cli import common, options
from unimm_torch.data.dataset import VisdialDataset
from unimm_torch.eval import evaluator
from unimm_torch.parallel import dist


def main(argv=None, device=None, backend=None):
    params = options.read_command_line(argv)
    dev = common.setup_torch(params, device, backend)
    cfg = common.build_config(params)
    tokenizer = common.load_tokenizer(params)
    reader = common.open_reader(params)

    dataset = VisdialDataset(params, tokenizer, reader)
    dataset.split = "val"
    eval_batch_size = 5 if params["overfit"] else 2
    loader = common.eval_loader(params, dataset, eval_batch_size)
    sharded = common.eval_sharded(params)
    print("len_dataloader_eval:", len(loader))

    ensemble = common.load_ensemble(params, cfg, dev)
    ranks = []
    metrics = evaluator.evaluate_ensemble(
        ensemble, cfg, loader, mode="nsp", chunk_size=params["eval_chunk"],
        dtype=common.compute_dtype(params), ranks_out=ranks,
        process_merge=sharded, split_rows=not sharded,
        pipeline_depth=params["eval_pipeline"],
        coalesce=params["eval_coalesce"], device=dev)
    name = (params["save_name"] or "val") + "_predictions.txt"
    if sharded:
        evaluator.dump_ranks_merged(ranks, name)
    else:
        evaluator.dump_ranks(ranks, name)
    if dist.rank() == 0:
        common.print_metrics(metrics)
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
