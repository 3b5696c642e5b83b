"""What the compiler made of the port's kernels: digests of the SASS of
the attention kernels' instances (``seq_attn_fwd_kernel``, the
backward's ``seq_attn_bwd_*``, K1's ``answer_attn_kernel``, the bench
probes' ``probe_attn_kernel`` and ``wo_acc_wg_kernel``), of the wgmma +
TMA GEMM core (``gemm_nt_wg_kernel``), of K3's ``xent_wg_kernel`` and of
the grouped expert GEMM's ``moe_wg_kernel``, to
show that a change to another kernel left their machine code as it was,
the names of every function the library holds, and ptxas's register and
spill report per kernel.

    python3 -m unimm_torch.tools.sass_digest [--csrc DIR] [--out FILE]
        [--compare FILE]

Without ``--csrc`` it reads the objects ``ops/_build`` keeps beside the
library (building it first if needed); with ``--csrc DIR`` it compiles that
tree's ``*.cu`` (another commit's sources, say) with the same nvcc flags
into a temporary directory. Every instance of ``seq_attn_fwd_kernel``
(the one-pass forward of B4, B5, B6, B9 and B10), of the backward's two
kernels (B5, B6), of ``gemm_nt_wg_kernel`` (K1, K2, B8, B4, B5, B10, B11),
of the probes' ``probe_attn_kernel`` and ``wo_acc_wg_kernel`` (B10, B11)
and of K1's and K3's own kernels is keyed by its source file and
demangled name and hashed over its
``cuobjdump -sass`` text (each instruction and its encoding, blanks
collapsed). ``--out`` writes the digests and the nvcc version
as JSON; ``--compare FILE`` prints, for each function of FILE, whether
this build's SASS has the same digest.
Needs the CUDA toolkit (nvcc, cuobjdump, cu++filt); no card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from unimm_torch.ops import _build

PATTERNS = ("seq_attn_fwd_kernel", "seq_attn_bwd_", "gemm_nt_wg_kernel",
            "answer_attn_kernel", "xent_wg_kernel", "probe_attn_kernel",
            "wo_acc_wg_kernel", "moe_wg_kernel")


def _tool(name: str) -> str:
    return str(Path(_build._nvcc()).parent / name)


def nvcc_version() -> str:
    out = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def compile_tree(csrc: Path, outdir: Path):
    """Compile every ``*.cu`` of ``csrc`` to ``outdir/<stem>.o`` with the
    library's flags, all at once; the objects' paths."""
    procs = []
    for cu in sorted(Path(csrc).glob("*.cu")):
        obj = Path(outdir) / f"{cu.stem}.o"
        procs.append((obj, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-c",
             str(cu), "-o", str(obj)], stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)))
    for obj, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {obj.stem}.cu:\n{err}")
    return [obj for obj, _ in procs]


def built_objects():
    """The objects of the library's current build."""
    _build.build()
    return sorted(_build.BUILD_DIR.glob("*.o"))


def _functions(obj: Path):
    """{mangled name: SASS text} of the object's sm_90a code."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(obj)],
                         capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None and line.strip():
            # runs of blanks collapsed: cuobjdump pads its columns to the
            # widest line of the whole object, which another function in
            # the same object can change
            funcs[name].append(" ".join(line.split()))
    return {k: "\n".join(v) for k, v in funcs.items()}


def _demangle(names):
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return out.splitlines()


def digests(objects) -> dict:
    """{"<source>.cu: <demangled name>": sha256 of its SASS} for the
    functions of ``objects`` whose demangled name contains one of
    PATTERNS."""
    found = {}
    for obj in objects:
        funcs = _functions(Path(obj))
        for mangled, plain in zip(funcs, _demangle(list(funcs))):
            if any(p in plain for p in PATTERNS):
                key = f"{Path(obj).stem}.cu: {plain}"
                found[key] = hashlib.sha256(
                    funcs[mangled].encode()).hexdigest()
    return dict(sorted(found.items()))


def kernel_names(objects) -> list:
    """The demangled name of every function in ``objects``' sm_90a code,
    each "<source>.cu: <name>"."""
    out = []
    for obj in objects:
        funcs = _functions(Path(obj))
        out += [f"{Path(obj).stem}.cu: {n}" for n in _demangle(list(funcs))]
    return out


def compare(recorded: dict, current: dict) -> dict:
    """Each recorded function: "same", "differs" or "absent" in
    ``current``; the functions only ``current`` has: "new"."""
    out = {k: "absent" if k not in current else
           "same" if current[k] == v else "differs"
           for k, v in recorded.items()}
    out.update({k: "new" for k in current if k not in recorded})
    return out


def ptxas_report(pattern: str):
    """ptxas's ``-v`` lines of the library's build for the kernels whose
    mangled name contains ``pattern``: one dict per (source, kernel)."""
    rows = []
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        cur = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = dict(source=log.stem + ".cu", kernel=m.group(1))
                if pattern in cur["kernel"]:
                    rows.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(stack_bytes=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=None,
                    help="compile this tree's *.cu instead of reading the "
                         "library's objects")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--compare", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.csrc is None:
        current = digests(built_objects())
    else:
        with tempfile.TemporaryDirectory() as tmp:
            current = digests(compile_tree(args.csrc.resolve(), Path(tmp)))
    record = {"nvcc": nvcc_version(), "flags": list(_build.NVCC_FLAGS),
              "digests": current}
    if args.out is not None:
        args.out.write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps(record))
    if args.compare is not None:
        recorded = json.loads(args.compare.read_text())
        print(json.dumps({"nvcc_recorded": recorded["nvcc"],
                          "nvcc": record["nvcc"],
                          "sass": compare(recorded["digests"], current)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
