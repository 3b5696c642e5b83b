"""The rank processes of the port's data-parallel tests
(``tests/test_torch_dist_*.py``).

As a script, ``python tests/_torch_dist_worker.py JOB RANK WORLD PORT
SPEC.json`` runs one rank of ``JOB`` on the CPU at two intra-op threads: it
joins a gloo world at ``127.0.0.1:PORT`` through the CLI flags
(``-coordinator_address -num_processes -process_id``), as a user launches
a rank, and writes what it measured to ``<spec["out"]>/<JOB>_<RANK>.npz``
and ``.json``. It imports no JAX: the tests hold the results against the
JAX package's single-process runs on the same global batches.

As a module, ``launch(job, spec)`` starts the ranks and returns a
``collect()`` that waits for them (a test computes its JAX oracle
meanwhile), each ``communicate()`` with its own timeout; on expiry every
rank is killed and the test fails, so a hang never eats the suite's time.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(job, spec, world=2):
    """Start ``job``'s ranks; returns ``collect()``, which waits for them
    and returns [(npz dict, json dict)] in rank order, failing with the
    ranks' output if one exits nonzero or any outlives TIMEOUT_S."""
    os.makedirs(spec["out"], exist_ok=True)
    path = os.path.join(spec["out"], f"{job}_spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         str(port), path], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return lambda: _collect(job, spec, procs)


def _collect(job, spec, procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{job}: a rank outlived {TIMEOUT_S} s")
    failed = [f"{job} rank {r} (exit {p.returncode}):\n{out[-4000:]}"
              for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    assert not failed, "\n".join(failed)
    res = []
    for r in range(len(procs)):
        base = os.path.join(spec["out"], f"{job}_{r}")
        with np.load(base + ".npz") as z:
            arrays = dict(z)
        with open(base + ".json") as f:
            res.append((arrays, json.load(f)))
    return res


def world_flags(rank, world, port):
    return ["-coordinator_address", f"127.0.0.1:{port}", "-num_processes",
            str(world), "-process_id", str(rank)]


# ---------------------------------------------------------------------------
# the jobs (run in the rank processes)
# ---------------------------------------------------------------------------

def job_eval(spec, flags, arrays, info):
    """The evaluation CLIs in both world modes, the sharded loader and
    ``allreduce_metrics``."""
    from unimm_torch.cli import common, evaluate, options, val, val_avg_lm
    from unimm_torch.cli import val_lm
    from unimm_torch.data.dataset import VisdialDataset
    from unimm_torch.eval import evaluator
    from unimm_torch.ops import metrics as M
    from unimm_torch.parallel import dist

    base = spec["argv"] + flags
    os.chdir(spec["root"])
    runs = {"lm_sharded": (val_lm, ["-eval_data_sharded", "1"]),
            "lm_serve": (val_lm, []),
            "avg_serve": (val_avg_lm, []),
            "val_sharded": (val, ["-eval_data_sharded", "1"]),
            "val_serve": (val, []),
            "ev_sharded": (evaluate, ["-eval_data_sharded", "1"])}
    info["metrics"] = {}
    for name, (mod, extra) in runs.items():
        ck = spec["lm_ckpt"] if mod in (val_lm, val_avg_lm) else \
            spec["ens_ckpt"]
        info["metrics"][name] = mod.main(
            base + extra + ck + ["-save_name", name], device="cpu")

    params = options.read_command_line(
        base + ["-eval_data_sharded", "1", "-save_name", "loader"])
    ds = VisdialDataset(params, common.load_tokenizer(params),
                        common.open_reader(params))
    ds.split = "val"
    info["loader"] = [
        {"image_id": [int(i) for i in b["image_id"]],
         "valid": ([bool(v) for v in b["valid"]] if "valid" in b else None)}
        for b in common.eval_loader(params, ds, spec["loader_batch"])]

    # dump_ranks: rank 0 alone writes, unless every rank writes its own
    mine = [{"image_id": dist.rank(), "round_id": 1, "ranks": [1]}]
    evaluator.dump_ranks(mine, "dump_rank0_only.json")
    evaluator.dump_ranks(mine, f"dump_all_{dist.rank()}.json",
                         all_processes=True)

    # allreduce_metrics: ranks with different observations, and a rank
    # that observed no row
    rng = np.random.default_rng(100 + dist.rank())
    for case in ("both", "empty"):
        sparse, ndcg = M.SparseGTMetrics(), M.NDCG()
        b = 3 + 2 * dist.rank()
        scores = rng.normal(size=(b, 10, 20)).astype(np.float32)
        gt = rng.integers(0, 20, (b, 10))
        rel = rng.choice([0.0, 0.5, 1.0], (b, 20)).astype(np.float32)
        if case == "empty" and dist.rank() == 1:
            scores, gt, rel = scores[:0], gt[:0], rel[:0]
        sparse.observe(scores, gt)
        ndcg.observe(scores[:, 0], rel)
        arrays.update({f"{case}_scores": scores, f"{case}_gt": gt,
                       f"{case}_rel": rel})
        info[f"allreduce_{case}"] = M.allreduce_metrics(sparse, ndcg)


def _model(spec, cfg_path, dev):
    import torch

    from unimm_torch.config import VilbertConfig
    from unimm_torch.models import vilbert

    cfg = VilbertConfig.from_json_file(cfg_path)
    model = vilbert.empty_model(cfg, dev)
    model.load_state_dict(torch.load(spec["weights"], weights_only=True))
    return cfg, model.train().requires_grad_(True)


def _grads(model):
    """Each parameter's .grad (a parameter without one: zeros)."""
    return {n: (np.zeros(p.shape, np.float32) if p.grad is None
                else p.grad.detach().numpy().copy())
            for n, p in model.named_parameters()}


def _applied(opt):
    """The gradients ``opt``'s updates apply (summed over the ranks), as
    {update index: [tensor per parameter]}, recorded as they happen."""
    applied = []
    update = opt._update

    def record(grads):
        applied.append([g.detach().clone() for g in grads])
        update(grads)
    opt._update = record
    return applied


def _named(model, tensors):
    return {n: t.numpy() for (n, _), t in zip(model.named_parameters(),
                                              tensors)}


def job_train(spec, flags, arrays, info):
    """One training step on this rank's rows (the global denominators);
    the same step with rank-mean losses (the wrong port); length-bucketed
    morsels under accumulation; the dropout streams; the dense step on a
    padded slate."""
    import torch

    from unimm_torch.cli import common, dense_finetune, options
    from unimm_torch.data.dataset import length_bucket_morsels
    from unimm_torch.models import unimm
    from unimm_torch.models import vilbert
    from unimm_torch.ops import losses as L
    from unimm_torch.parallel import dist
    from unimm_torch.train import optim, step as tstep

    params = options.read_command_line(flags + ["-save_name", "train"])
    dev = common.setup_torch(params, "cpu")
    r = dist.rank()
    with np.load(spec["batches"]) as z:
        data = dict(z)
    flats = [{k[len(f"r{r}f{j}_"):]: v for k, v in data.items()
              if k.startswith(f"r{r}f{j}_")} for j in range(2)]
    joined = {k: np.concatenate([f[k] for f in flats]) for k in flats[0]}
    # the step's batch holds one row per image (each flat's rows share
    # one), as the train CLI stages it
    n = flats[0]["tokens"].shape[0]
    compact = dict(joined, img_index=np.repeat(np.arange(2), n))
    for k in ("image_feat", "image_loc", "image_mask", "image_target",
              "image_label"):
        compact[k] = joined[k][::n]
    nw = torch.tensor(spec["nsp_weight"])
    ocfg = optim.OptimConfig(lr=1e-3, image_lr=1e-3, warmup_steps=1,
                             t_total=100)

    def tens(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in b.items()}

    # (1) the step on this rank's rows: losses over the world's counts
    cfg, model = _model(spec, spec["cfg"], dev)
    opt = optim.make_optimizer(model, ocfg)
    applied = _applied(opt)
    state = tstep.init_state(model, opt, seed=0)
    step = tstep.make_train_step(cfg, dtype=torch.float32)
    with torch.enable_grad():
        state, m = step(state, tens(compact), nw)
    arrays.update({f"step_grad/{n}": g
                   for n, g in _named(model, applied[0]).items()})
    arrays.update({f"step_param/{n}": p.detach().numpy()
                   for n, p in model.named_parameters()})
    info["step_metrics"] = {k: float(v) for k, v in m.items()}

    # (2) the wrong port: each rank's loss over its own counts, the
    # gradients averaged over the ranks (a DDP default)
    cfg, model = _model(spec, spec["cfg"], dev)
    with torch.enable_grad():
        parts = unimm.forward_train(model, cfg, tens(joined), nsp_weight=nw,
                                    dtype=torch.float32)
        loss = L.combine_losses(parts["lm"], parts["img"], parts["nsp"])
        (loss / dist.world_size()).backward()
    mean = [torch.from_numpy(g) for g in _grads(model).values()]
    dist.allreduce_sum_(mean)
    arrays.update({f"mean_grad/{n}": g
                   for n, g in _named(model, mean).items()})

    # (3) two length-bucketed morsels, accumulated (-batch_multiply 2)
    cfg, model = _model(spec, spec["cfg"], dev)
    opt = optim.make_optimizer(model, optim.OptimConfig(
        lr=1e-3, image_lr=1e-3, warmup_steps=1, t_total=100,
        batch_multiply=2))
    applied = _applied(opt)
    state = tstep.init_state(model, opt, seed=0)
    morsels = length_bucket_morsels(
        flats, cfg.max_seq_len, 2, div=4,
        sync=lambda s: np.stack(dist.allgather_np(s)))
    info["morsel_lengths"] = [int(mo["tokens"].shape[1]) for mo in morsels]
    info["morsel_norms"] = [float(morsels[0]["lm_norm"]),
                            float(morsels[0]["img_norm"])] + [
        float(x) for x in morsels[0]["nsp_norm_counts"]]
    with torch.enable_grad():
        for mo in morsels:
            state, _ = step(state, tens(mo), nw)
    assert len(applied) == 1
    arrays.update({f"morsel_grad/{n}": g
                   for n, g in _named(model, applied[0]).items()})

    # (4) dropout: the same rows on every rank, the rank in the seed
    cfg, model = _model(spec, spec["drop_cfg"], dev)
    same = tens({k[len("r0f0_"):]: v for k, v in data.items()
                 if k.startswith("r0f0_")})
    losses = {}
    for key, rank_in in (("rank_seed", tstep.world_rank()),
                         ("one_process_seed", None)):
        rng = vilbert.DropoutRng(tstep.step_seed(0, 0, rank_in), dev)
        with torch.no_grad():
            p = unimm.forward_train(model, cfg, same, rng=rng, nsp_weight=nw,
                                    dtype=torch.float32)
        losses[key] = float(L.combine_losses(p["lm"], p["img"], p["nsp"]))
    info["dropout_losses"] = losses

    # (5) the dense step on a slate of n_real rows padded to the world
    cfg, model = _model(spec, spec["cfg"], dev)
    opt = optim.make_optimizer(model, ocfg)
    applied = _applied(opt)
    state = tstep.init_state(model, opt, 0)
    slate = {k[len("slate_"):]: v for k, v in data.items()
             if k.startswith("slate_") and k != "slate_gt_relevance"}
    n_real = int(slate["tokens"].shape[0])
    block = dense_finetune.slate_block(slate, n_real)
    info["slate_rows"] = int(block["tokens"].shape[0])
    dense = dense_finetune.make_dense_step(cfg, dtype=torch.float32,
                                           n_real=n_real)
    with torch.enable_grad():
        state, parts = dense(state, tens(block),
                             torch.from_numpy(data["slate_gt_relevance"]))
    arrays.update({f"dense_grad/{n}": g
                   for n, g in _named(model, applied[0]).items()})
    info["dense_parts"] = {k: float(v) for k, v in parts.items()}


def job_persist(spec, flags, arrays, info):
    """The train CLI from a start .ckpt (one epoch, a save and the val
    ranking), then -continue from its native directory: only rank 0
    writes, every rank restores the same step, the ranks' weights stay
    bit-equal."""
    import hashlib

    from unimm_torch.cli import train

    os.chdir(spec["root"])
    base = spec["argv"] + flags
    first = train.main(base + spec["first"], device="cpu")
    info["first_step"] = first["step"]
    second = train.main(base + spec["second"], device="cpu")
    info["second_step"] = second["step"]
    h = hashlib.sha256()
    for _, p in second["model"].named_parameters():
        h.update(p.detach().numpy().tobytes())
    info["weights_sha256"] = h.hexdigest()
    info["adam_count"] = second["opt"].count
    del first


JOBS = {"eval": job_eval, "train": job_train, "persist": job_persist}


def main(argv):
    job, rank, world, port, spec_path = argv
    import torch
    torch.set_num_threads(2)
    with open(spec_path) as f:
        spec = json.load(f)
    arrays, info = {}, {}
    JOBS[job](spec, world_flags(int(rank), int(world), int(port)), arrays,
              info)
    base = os.path.join(spec["out"], f"{job}_{rank}")
    np.savez(base + ".npz", **arrays)
    with open(base + ".json", "w") as f:
        json.dump(info, f)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1:])
