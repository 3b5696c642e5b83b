"""Discriminative ensemble on the VisDial test split -> EvalAI predictions.

The port's counterpart of the JAX package's ``cli/evaluate.py`` (the
reference's evaluate.py): 100 candidates at the last round per image,
per-model NSP probabilities min-max normalised per slate, summed, ranks
written in the EvalAI submission format. In a data-parallel world the
ranks split every chunk's rows, or, with ``-eval_data_sharded 1``, score
disjoint shards merged into one file (``cli/val_lm.py``).
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

    params = dict(params, num_options=100)
    dataset = VisdialDataset(params, tokenizer, reader)
    dataset.split = "test"
    loader = common.eval_loader(params, dataset, 4)
    sharded = common.eval_sharded(params)
    print("len_dataloader_eval:", len(loader))

    ensemble = common.load_ensemble(params, cfg, dev)
    ranks = []
    evaluator.evaluate_ensemble(
        ensemble, cfg, loader, mode="nsp", chunk_size=params["eval_chunk"],
        dtype=common.compute_dtype(params), ranks_out=ranks, test_split=True,
        split_rows=not sharded, pipeline_depth=params["eval_pipeline"],
        coalesce=params["eval_coalesce"], device=dev)
    out = (params["save_name"] or "evaluate") + "_predictions.txt"
    if sharded:
        n = evaluator.dump_ranks_merged(ranks, out)
    else:
        evaluator.dump_ranks(ranks, out)
        n = len(ranks)
    if dist.rank() == 0:
        print("wrote", out, n, "records")


if __name__ == "__main__":
    main(sys.argv[1:])
