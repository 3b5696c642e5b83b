"""Generative ranking on VisDial val by sequence log-likelihood.

The port's counterpart of the JAX package's ``cli/val_lm.py`` (the
reference's val_lm.py, and val_avg_lm.py through the val_avg_lm entry):
ranks all candidates per round by answer log-likelihood from the
autoregressive-MLM layout through the prefix-cache scorer (on the card: the
answer block, FFN and label-head kernels), reports R@k/MRR/mean/NDCG and
dumps a predictions JSON.

Usage: python -m unimm_torch.cli.val_lm -val_dis 0 -start_path model.ckpt ...
(on the card; ``main(argv, device="cpu")`` runs the plain versions on the
CPU). One process per card in a data-parallel world: add
``-coordinator_address host:port -num_processes N -process_id r`` to each
rank's command (and ``-mesh_mp M`` to shard the model over groups of M
ranks); the dp groups then split every prefix group's slates, or, with
``-eval_data_sharded 1``, each rank scores a disjoint shard of the split
with its model whole and the metrics and predictions are merged. Rank 0
writes the predictions file and reports.
"""

from __future__ import annotations

import sys

from unimm_torch.cli import common, options
from unimm_torch.data.dataset import VisdialDataset
from unimm_torch.eval import evaluator
from unimm_torch.parallel import dist


def main(argv=None, mode: str = "ll_sum", device=None, backend=None):
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

    model = common.serving_model(params, common.init_model(params, cfg, dev))
    ranks = []
    metrics = evaluator.evaluate_split(
        model, cfg, loader, mode=mode,
        chunk_size=params["eval_chunk"], dtype=common.compute_dtype(params),
        ranks_out=ranks,
        gen_prefix=bool(params["gen_prefix"]),
        prefix_group=params["prefix_group"],
        prefix_packed=bool(params["prefix_packed"]),
        prefix_rowblock=params["prefix_rowblock"], process_merge=sharded,
        split_rows=not sharded, pipeline_depth=params["eval_pipeline"],
        coalesce=params["eval_coalesce"], device=dev)
    name = params["save_name"] or "val_lm"
    if sharded:
        evaluator.dump_ranks_merged(ranks, name + "_predictions.txt")
    else:
        evaluator.dump_ranks(ranks, name + "_predictions.txt")
    if dist.rank() == 0:
        common.print_metrics(metrics)
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
