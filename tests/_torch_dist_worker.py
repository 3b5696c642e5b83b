"""The rank processes of the port's tests across processes
(``tests/test_torch_dist_*.py``, ``tests/test_torch_mp_*.py``).

As a script, ``python tests/_torch_dist_worker.py JOB RANK WORLD PORT
SPEC.json`` runs one rank of ``JOB`` on the CPU at ``THREADS`` intra-op
threads: it joins a gloo world at ``127.0.0.1:PORT`` through the CLI
flags (``-coordinator_address -num_processes -process_id``), as a user
launches a rank, and writes what it measured to
``<spec["out"]>/<JOB>_<RANK>.npz`` and ``.json``. It imports no JAX: the
tests hold the results against the JAX package's single-process runs on
the same global batches.

As a module, ``launch(job, spec)`` starts the ranks (each writing its
output to ``<spec["out"]>/<JOB>_<RANK>.log``) and returns a ``collect()``
that waits for them (a test computes its JAX oracle meanwhile), each wait
with its own timeout; on expiry every rank is killed and the test fails,
so a hang never eats the suite's time.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
# a rank's intra-op threads; a one-process run held bit for bit against
# the ranks uses as many (``rank_threads``): the CPU kernels' reduction
# order follows the thread count
THREADS = 2


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(job, spec, world=2, timeout=TIMEOUT_S):
    """Start ``job``'s ``world`` ranks (2 or 4); returns ``collect()``,
    which waits for them and returns [(npz dict, json dict)] in rank
    order, failing with the ranks' output if one exits nonzero or any
    outlives ``timeout`` seconds."""
    os.makedirs(spec["out"], exist_ok=True)
    path = os.path.join(spec["out"], f"{job}_spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    # each rank's output goes to a file: a pipe would block a rank whose
    # output outgrew it while another rank's was read, and its peers with
    # it in their next collective
    logs = [os.path.join(spec["out"], f"{job}_{r}.log") for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, str(r),
                 str(world), str(port), path], cwd=REPO, env=env, stdout=f,
                stderr=subprocess.STDOUT))
    return lambda: _collect(job, spec, procs, logs, timeout)


def _collect(job, spec, procs, logs, timeout):
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"{job}: a rank outlived {timeout} s")
    outs = []
    for log in logs:
        with open(log) as f:
            outs.append(f.read())
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


@contextlib.contextmanager
def rank_threads():
    """Run the block at a rank's intra-op thread count."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(n)


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


def _rank_of(flags):
    return int(flags[flags.index("-process_id") + 1])


def _global_flat(data, dps):
    """The rows of dp indices ``dps`` (each two flats, as ``job_train``'s)
    joined, one image row a flat (``img_index``)."""
    flats = [{k[len(f"r{d}f{j}_"):]: v for k, v in data.items()
              if k.startswith(f"r{d}f{j}_")} for d in dps for j in range(2)]
    joined = {k: np.concatenate([f[k] for f in flats]) for k in flats[0]}
    n = flats[0]["tokens"].shape[0]
    out = dict(joined, img_index=np.repeat(np.arange(len(flats)), n))
    for k in ("image_feat", "image_loc", "image_mask", "image_target",
              "image_label"):
        out[k] = joined[k][::n]
    return out


def mp_steps(spec, cfg_path, batch, steps, dev):
    """``steps`` training steps (fp32, plain AdamW at lr 1e-3) of the
    spec's weights, sharded over the current grid's mp group, on the
    host ``batch``. Returns (model, optimizer, the gradients each update
    applied: this rank's tensors, summed over the dp group)."""
    import torch

    from unimm_torch.parallel import mesh
    from unimm_torch.train import optim, step as tstep

    cfg, model = _model(spec, cfg_path, dev)
    mesh.shard_model(model)
    opt = optim.make_optimizer(model, optim.OptimConfig(
        lr=1e-3, image_lr=1e-3, warmup_steps=1, t_total=100))
    applied = _applied(opt)
    state = tstep.init_state(model, opt, seed=0)
    step = tstep.make_train_step(cfg, dtype=torch.float32)
    tens = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}
    nw = torch.tensor(spec["nsp_weight"])
    with torch.enable_grad():
        for _ in range(steps):
            state, _ = step(state, tens, nw)
    return model, opt, applied


def _whole_np(model, items, prefix, arrays):
    """Each (name, this rank's tensor) gathered whole over the mp group,
    into ``arrays`` as ``<prefix>/<name>``."""
    from unimm_torch.parallel import mesh
    for n, t in mesh.whole(model, items, lambda t: t.detach().clone()):
        arrays[f"{prefix}/{n}"] = t.numpy()


def _replicated_sha(model):
    """SHA-256 over the bytes of the parameters this rank holds whole."""
    import hashlib

    from unimm_torch.parallel import mesh
    lay = mesh.layout(model)
    h = hashlib.sha256()
    for n, p in model.named_parameters():
        if lay is None or n not in lay.dims:
            h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def job_mp(spec, flags, arrays, info):
    """The mp axis: in a world of 4 at -mesh_mp 2 (dp 2 x mp 2) one step
    on each dp index's rows (its gradients gathered whole), the same step
    with the losses and gradients summed over the world instead of the dp
    group (the wrong port), 2 steps at dropout 0.1, and the train CLI;
    then ranks 0-1 and 2-3 form two worlds of 2: (dp 2, mp 1) takes the
    same 2 steps, (dp 1, mp 2) takes them on the whole batch (and again
    with dropout seeded by the world rank: the wrong port), and runs
    val_lm, val and evaluate serving, dense_finetune and train (a save,
    and a resume from the one-process run's save) at -mesh_mp 2."""
    from unimm_torch.cli import common, dense_finetune, evaluate, options
    from unimm_torch.cli import train, val, val_lm
    from unimm_torch.parallel import dist
    from unimm_torch.train import step as tstep

    r = _rank_of(flags)
    params = options.read_command_line(flags + ["-mesh_mp", "2",
                                                "-save_name", "mp"])
    dev = common.setup_torch(params, "cpu")
    with np.load(spec["batches"]) as z:
        data = dict(z)
    mine = _global_flat(data, [dist.dp_rank()])
    info["grid"] = [dist.dp_rank(), dist.dp_size(), dist.mp_rank(),
                    dist.mp_size()]

    # (1) the step on the dp index's rows; the layout's bytes
    model, opt, applied = mp_steps(spec, spec["cfg"], mine, 1, dev)
    _whole_np(model, zip(opt.names, applied[0]), "mp_grad", arrays)
    info["param_bytes"] = sum(p.numel() * p.element_size()
                              for p in model.parameters())
    info["storage_bytes"] = sum(p.untyped_storage().nbytes()
                                for p in model.parameters())
    info["moments_like_params"] = all(
        m.shape == p.shape for m, p in zip(opt.mu + opt.nu,
                                           opt.params + opt.params))
    # (2) the wrong port: every collective of the step over the world
    dp_axis = dist.DP
    dist.DP = dist.WORLD
    try:
        model, opt, applied = mp_steps(spec, spec["cfg"], mine, 1, dev)
    finally:
        dist.DP = dp_axis
    _whole_np(model, zip(opt.names, applied[0]), "world_sum_grad", arrays)
    # (3) dropout 0.1, 2 steps
    model, _, _ = mp_steps(spec, spec["drop_cfg"], mine, 2, dev)
    _whole_np(model, model.named_parameters(), "dp2mp2", arrays)
    info["replicated_sha"] = _replicated_sha(model)
    # (4) the train CLI at -mesh_mp 2 in the world of 4
    os.chdir(spec["root"])
    train.main(spec["argv"] + flags + ["-n_gpus", "4", "-mesh_mp", "2"]
               + spec["train"] + ["-save_name", "mp_dp2mp2"], device="cpu")

    # two worlds of 2: ranks 0-1 at mp 1, ranks 2-3 at mp 2
    dist.close_world()
    mp = 1 if r < 2 else 2
    sub = world_flags(r % 2, 2, spec["ports"][r // 2]) + [
        "-n_gpus", "2", "-mesh_mp", str(mp)]
    common.setup_torch(options.read_command_line(sub + ["-save_name", "x"]),
                       "cpu")
    info["sub_grid"] = [dist.dp_rank(), dist.dp_size(), dist.mp_rank(),
                        dist.mp_size()]
    if mp == 1:
        model, _, _ = mp_steps(spec, spec["drop_cfg"],
                               _global_flat(data, [dist.dp_rank()]), 2, dev)
        _whole_np(model, model.named_parameters(), "dp2mp1", arrays)
        return
    both = _global_flat(data, [0, 1])
    model, _, _ = mp_steps(spec, spec["drop_cfg"], both, 2, dev)
    _whole_np(model, model.named_parameters(), "dp1mp2", arrays)
    info["sub_replicated_sha"] = _replicated_sha(model)
    world_rank = tstep.world_rank
    tstep.world_rank = dist.rank          # the wrong port
    try:
        model, _, _ = mp_steps(spec, spec["drop_cfg"], both, 2, dev)
    finally:
        tstep.world_rank = world_rank
    _whole_np(model, model.named_parameters(), "rank_seed", arrays)

    base = spec["argv"] + sub
    val_lm.main(base + spec["val_lm"] + ["-save_name", "mp_lm"],
                device="cpu")
    val.main(base + spec["ensemble"] + ["-save_name", "mp_val"],
             device="cpu")
    evaluate.main(base + spec["ensemble"] + ["-save_name", "mp_ev"],
                  device="cpu")
    dense_finetune.main(base + spec["dense"] + ["-save_name", "mp_dense"],
                        device="cpu")
    train.main(base + spec["train"] + ["-save_name", "mp_save"],
               device="cpu")
    train.main(base + spec["train"] + spec["resume_one"]
               + ["-save_name", "mp_from_one"], device="cpu")


JOBS = {"eval": job_eval, "train": job_train, "persist": job_persist,
        "mp": job_mp}


def main(argv):
    job, rank, world, port, spec_path = argv
    import torch
    torch.set_num_threads(THREADS)
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
