"""Build the port's CUDA kernels at first use and bind them with ctypes.

``unimm_torch/csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` into
``build/unimm_torch/libunimm_kernels.so`` at the repository root: one nvcc
process per source, all started together, then one link. The library is
rebuilt when the hash of the sources, headers or flags changes. The C entry
points take raw device pointers and the CUDA stream as ``void*`` and return
``cudaGetLastError()``; ``check`` turns a nonzero code into an exception.
A failed build raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "unimm_torch"
LIB_NAME = "libunimm_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran, if any

_VP, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U32, _I64 = ctypes.c_uint, ctypes.c_long
_SIGNATURES = {
    # x, kc, vc, b_ctx, b_rr, table, ten weights, q, k, v, ctx, pre, out;
    # G, P, Lcb, RB; eps
    "unimm_answer_block": [_VP] * 22 + [_INT] * 4 + [_F32, _VP],
    "unimm_ffn_block": [_VP] * 10 + [_INT] * 3 + [_F32, _VP],
    # hidden, labels, decoder, bias, partials, label logits, nll; M, V
    "unimm_xent_head": [_VP] * 7 + [_INT] * 2 + [_VP],
    # the same at width 2048 without a bias
    "unimm_xent_head_2048": [_VP] * 6 + [_INT] * 2 + [_VP],
    # a sorted by expert, stacked weights, row and tile offsets, out; M, G,
    # N, K
    "unimm_moe_swiglu": [_VP] * 5 + [_INT] * 4 + [_VP],
    # ..., row weights (or null), out; M, G, N, K
    "unimm_moe_down": [_VP] * 6 + [_INT] * 4 + [_VP],
    # mode; out int32[4]
    "unimm_moe_info": [_INT, _VP],
    # qf, cache, kr, tiles, first, n_ctx, out; N, nh, G, Lcb, row tiles
    "unimm_mla_answer": [_VP] * 7 + [_INT] * 5 + [_VP],
    "unimm_mla_answer_info": [_INT, _VP],
    # hidden, labels, decoder, bias, partials, label logits, nll, lse; M, V
    "unimm_xent_train_fwd": [_VP] * 8 + [_INT] * 2 + [_VP],
    # hidden, labels, decoder, bias, lse, gf, dl, part_db, dh, dw, db; M, V
    "unimm_xent_train_bwd": [_VP] * 11 + [_INT] * 2 + [_VP],
    # x, desc, ten weights, q, k, v, ctx, pre, out; B, L, block_b; eps
    "unimm_attention_block": [_VP] * 18 + [_INT] * 3 + [_F32, _VP],
    "unimm_co_text_block": [_VP] * 19 + [_INT] * 3 + [_F32, _VP],
    # x, desc, ten weights, mo, q, k, v, ctx, pre, out; B, L; eps, seed,
    # thresh, inv_keep, drop
    "unimm_attention_block_train_fwd": ([_VP] * 19 + [_INT] * 2
                                        + [_F32, _U32, _U32, _F32, _INT,
                                           _VP]),
    # ..., dqkv, dx, stats scratch; B, L; seed, thresh, inv_keep, drop
    "unimm_attention_block_train_bwd": ([_VP] * 16 + [_INT] * 2
                                        + [_U32, _U32, _F32, _INT, _VP]),
    "unimm_adamw": [_VP] * 4 + [_I64] + [_F32] * 9 + [_VP],
    # q, k, v, desc, out; B, H, L; strides (sequence, head, row); scale
    "unimm_text_attention_fwd": ([_VP] * 5 + [_INT] * 3 + [_I64, _I64, _INT]
                                 + [_F32, _VP]),
    # q, k, v, do, desc, dq, dk, dv, stats scratch; B, H, L; strides; scale
    "unimm_text_attention_bwd": ([_VP] * 9 + [_INT] * 3 + [_I64, _I64, _INT]
                                 + [_F32, _VP]),
    "unimm_attention_v2": ([_VP] * 5 + [_INT] * 3 + [_I64, _I64, _INT, _INT]
                           + [_F32, _VP]),
    # L; out int32[4]
    "unimm_text_attention_fwd_info": [_INT, _VP],
    "unimm_answer_block_info": [_INT, _VP],
    "unimm_attention_v2_info": [_INT, _VP],
    "unimm_attention_block_info": [_INT, _VP],
    # L, drop; out
    "unimm_attention_block_train_fwd_info": [_INT, _INT, _VP],
    # L; kernel (0 the dq launch, 1 the dk / dv launch), drop, split; out
    "unimm_seq_attn_bwd_info": [_INT] * 4 + [_VP],
    # x, desc, ten weights, q, k, v, ctx, pre, out; B, L, mode / layout;
    # eps
    "unimm_probe_block": [_VP] * 18 + [_INT] * 3 + [_F32, _VP],
    "unimm_layout_probe_block": [_VP] * 18 + [_INT] * 3 + [_F32, _VP],
    # L, kernel; out
    "unimm_block_probe_info": [_INT, _INT, _VP],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of unimm_torch "
                       "are built from source at first use and need the "
                       "CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernels unless an up-to-date library exists; return its
    path. Compiler output (including ``-Xptxas -v`` register and shared
    memory counts) is kept in ``build/unimm_torch/<source>.log``, each
    source's object in ``build/unimm_torch/<source>.o``."""
    global build_seconds
    cus, headers = _sources()
    digest = _digest(cus + headers)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "hash"
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # object and library names carry the pid: processes that build at the
    # same time never write one file; os.replace publishes the library
    objs = [BUILD_DIR / f"{cu.stem}.{os.getpid()}.o" for cu in cus]
    procs = []
    for cu, obj in zip(cus, objs):
        log = open(BUILD_DIR / (cu.stem + ".log"), "w")
        procs.append((cu, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(cu), "-o",
             str(obj)], stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for cu, log, proc in procs:
        proc.wait()
        log.close()
        if proc.returncode:
            failed.append(cu.name)
    if failed:
        logs = "\n".join((BUILD_DIR / (Path(n).stem + ".log")).read_text()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    tmp = BUILD_DIR / (LIB_NAME + f".{os.getpid()}.tmp")
    subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                   check=True, capture_output=True)
    os.replace(tmp, lib)
    for cu, obj in zip(cus, objs):      # kept for tools/sass_digest
        os.replace(obj, BUILD_DIR / f"{cu.stem}.o")
    stamp.write_text(digest)
    build_seconds = time.perf_counter() - t0
    return lib


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def kernel_info(entry: str, L: int, *which: int) -> dict:
    """What the C entry point ``entry`` (a ``*_info`` function) reports of
    its kernel at sequence length L (``which``: the kernel of an entry point
    that launches several): registers and local memory bytes a thread
    (stack and spills), dynamic shared memory a CTA, CTAs an SM."""
    out = (ctypes.c_int * 4)()
    check(getattr(library(), entry)(L, *which, ctypes.addressof(out)),
          entry)
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "ctas_per_sm"), out))


def check(code: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if code:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
