"""The run's last line, the device it ran on, and the guard that the
process never loaded JAX."""

from __future__ import annotations

import json
import subprocess
import sys

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "unimm_tpu")


def loaded_forbidden():
    """Top-level names of ``FORBIDDEN`` modules in this process (compared
    whole: ``unimm_torch`` is not ``unimm_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card():
    """(name, power limit) of card 0 as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or "unknown"


def device_info(device, chips: int, memory_peak_bytes: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(memory_peak_bytes)}


def emit(result: dict, checks: dict):
    """Print each compared number beside its limit on stderr (last), and
    the result as the last line of stdout, its ``checks`` key last."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
