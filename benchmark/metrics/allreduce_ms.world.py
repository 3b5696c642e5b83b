"""Device ms a step of the collectives that sum the gradients over the
world (the NCCL kernels named in ``allreduce_ms.world.json``), over the
traced slice, the mean over the ranks."""

from benchmark.harness.readers import names_beside


def read(ctx):
    t, w = ctx["trace"], ctx["slice_work"]
    if not t or not w or not w.get("steps") or "ranks" not in t:
        return None
    names = names_beside(__file__)
    per_rank = [sum(v[0] for k, v in r["kernels"].items()
                    if any(x in k for x in names)) for r in t["ranks"]]
    if not any(per_rank):
        return None
    return sum(per_rank) / len(per_rank) * 1e3 / w["steps"]
