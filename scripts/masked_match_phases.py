#!/usr/bin/env python3
"""Where the masked match's time goes on the card (``csrc/hamming.cu``:
``mm_bin`` + ``mm_match``), at chip_smoke.py's shapes (2048 x 16384, radius
50, uniform over a 900 px square, and every target in one 100 px square).

    python3 scripts/masked_match_phases.py                  # phases, then variants
    python3 scripts/masked_match_phases.py --variants base  # one variant only

Phases: a copy of the source with a %globaltimer read by thread 0 of each
block at the kernels' phase boundaries, built into build/masked_match_phases/
and run once per problem; prints, per phase, the median over blocks of the
time from the block's start (mm_match: of the blocks' first work items).
Variants: copies of the source with one edit each, built in parallel and
timed by the profiler's device time per kernel (median of 30 calls).  Those
marked "diagnostic" compute wrong distances on purpose, to weigh one
resource of the compare loop; they are reported, not checked.  Needs one
CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "masked_match_phases"

TIMER = r'''
__device__ unsigned long long* g_marks;
__device__ __forceinline__ void mark(int k, int row) {
  if (threadIdx.x == 0 && g_marks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_marks[(size_t)row * 16 + k] = t;
  }
}
'''
# (text in the source, mark, before or after it); mm_bin's blocks write rows
# 0-15, mm_match's rows 32 + blockIdx.x (its first item only past mark 3)
BIN_MARKS = [
    ("  const int rank = (int)cluster.block_rank();\n", 0, "after"),
    ("  const int n_loop = max(", 1, "before"),
    ("  cluster.sync();  // every block's table is out", 2, "before"),
    ("  cluster.sync();  // every block's table is out (the barrier orders global memory too)\n",
     3, "after"),
    ("  // exclusive scans of the three tables", 4, "before"),
    ("  __syncthreads();  // every offset is in place before any thread scatters\n", 5, "after"),
]
BIN_PHASES = ["zero", "count + table out", "cluster barrier", "tables back + items", "scans",
              "scatter"]
MATCH_MARKS = [
    ("  const int S = 1 << (2 * a.lg);\n  for (int k = tid; k <= S;", 0, "before"),
    ("  const int n_items = s_items[S];\n", 1, "after"),
    ("    int nc = 0;\n#pragma unroll\n    for (int i = 0; i < 9; ++i) nc += sRn[i];\n", 2,
     "before"),
    ("    if (warp < nq) {  // a warp per query", 3, "before"),
    ("    if (n_chunks > 1) {  // the block", 4, "before"),
    ("    __syncthreads();  // the shared arrays are staged again for the next item\n", 5,
     "after"),
]
MATCH_PHASES = ["items' starts", "slot's ranges", "chunk staged", "warp 0's query",
                "every warp's query"]

POPC8 = ("          const int d = __popc(x0.x ^ y0.x) + __popc(x0.y ^ y0.y) + "
         "__popc(x0.z ^ y0.z) +\n"
         "                        __popc(x0.w ^ y0.w) + __popc(x1.x ^ y1.x) + "
         "__popc(x1.y ^ y1.y) +\n"
         "                        __popc(x1.z ^ y1.z) + __popc(x1.w ^ y1.w);\n")
POPC1 = ("          const int d = __popc(x0.x ^ y0.x ^ x0.y ^ y0.y ^ x0.z ^ y0.z ^ x0.w ^ y0.w ^ "
         "x1.x ^ y1.x ^ x1.y ^ y1.y ^ x1.z ^ y1.z ^ x1.w ^ y1.w);\n")
VARIANTS = {
    "base": {},
    "chunk 512": {"constexpr int CH = 768; ": "constexpr int CH = 512; "},
    "chunk 1024": {"constexpr int CH = 768; ": "constexpr int CH = 1024;"},
    "one popcount (diagnostic)": {POPC8: POPC1},
    "no word loads (diagnostic)": {
        "          const uint4 y0 = sW[0][j], y1 = sW[1][j];\n":
            "          const uint4 y0 = make_uint4(j, 3u * j, 5u * j, 7u * j), "
            "y1 = make_uint4(11u * j, j, j, j);\n"},
}


def edited(src: str, edits: dict) -> str:
    for old, new in edits.items():
        if old not in src:
            raise SystemExit(f"the source no longer holds {old[:60]!r}: update this script")
        src = src.replace(old, new, 1)
    return src


def with_marks(src: str) -> str:
    src = src.replace("namespace {\n", "namespace {\n" + TIMER, 1)
    for marks, row in ((BIN_MARKS, "blockIdx.x"), (MATCH_MARKS, "32 + blockIdx.x")):
        for text, k, where in marks:
            cond = "" if marks is BIN_MARKS or k < 2 else "if (item == (int)blockIdx.x) "
            line = f"  {cond}mark({k}, {row});\n"
            src = edited(src, {text: line + text if where == "before" else text + line})
    end = "(unsigned)i, 0u);\n    }\n  }\n}\n"
    src = edited(src, {end: end[:-2] + "  mark(6, blockIdx.x);\n}\n"})
    return src + '\nextern "C" int set_marks(void* p) {\n' \
                 '  return (int)cudaMemcpyToSymbol(g_marks, &p, sizeof(p));\n}\n'


def build(named: dict) -> dict:
    from fishbirdeyevisualslam_torch import _cuda
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in named.items():
        stem = "".join(c if c.isalnum() else "_" for c in name)
        (OUT / f"{stem}.cu").write_text(src)
        lib = OUT / f"lib{stem}.so"
        procs[name] = (lib, subprocess.Popen(
            [_cuda.nvcc_path(), *_cuda.FLAGS, "-o", str(lib), str(OUT / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} copy:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def problems(torch, dev):
    rng = np.random.RandomState(0)
    na, nb = 2048, 16384
    words = lambda k: torch.from_numpy(rng.randint(0, 2**32, (k, 8), dtype=np.uint64)
                                       .astype(np.uint32).view(np.int32)).to(dev)
    da, db = words(na), words(nb)
    uva = torch.from_numpy(rng.uniform(0, 900, (na, 2)).astype(np.float32)).to(dev)
    uvb = torch.from_numpy(rng.uniform(0, 900, (nb, 2)).astype(np.float32)).to(dev)
    uvc = torch.from_numpy(np.random.RandomState(1).uniform(400, 500, (nb, 2))
                           .astype(np.float32)).to(dev)
    vb = torch.ones(nb, dtype=torch.bool, device=dev)
    return {"uniform": (da, uva, db, uvb, vb, 50.0), "clustered": (da, uva, db, uvc, vb, 50.0)}


def caller(torch, lib, args):
    from fishbirdeyevisualslam_torch.ops import cuda_matcher as cm
    da, uva, db, uvb, vb, radius = args
    na, nb = da.shape[0], db.shape[0]
    vp, ci, cf, cz = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t
    lib.masked_match_scratch.argtypes = [ci, ci, ci]
    lib.masked_match_scratch.restype = cz
    lg = cm.masked_table_log2(nb)
    n = lib.masked_match_scratch(na, nb, lg)
    scratch = torch.empty(n, dtype=torch.uint8, device=da.device)
    out = (torch.empty(na, device=da.device), torch.empty(na, device=da.device),
           torch.empty(na, dtype=torch.int32, device=da.device))
    fn = lib.masked_match
    fn.argtypes = [vp, vp, ci, vp, vp, vp, ci, cf, cf, ci, vp, cz, vp, vp, vp, vp]
    fn.restype = ci

    def call():
        err = fn(da.data_ptr(), uva.data_ptr(), na, db.data_ptr(), uvb.data_ptr(),
                 vb.data_ptr(), nb, radius, cm.masked_cell_scale(radius), lg,
                 scratch.data_ptr(), n, *(o.data_ptr() for o in out),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"masked_match: CUDA error {err}")
        return out
    return call


def phases(torch, lib, probs) -> None:
    from fishbirdeyevisualslam_torch.ops import cuda_matcher as cm
    marks = torch.zeros((32 + 4096, 16), dtype=torch.int64, device="cuda")
    lib.set_marks.argtypes = [ctypes.c_void_p]
    if lib.set_marks(marks.data_ptr()):
        raise SystemExit("set_marks failed")
    for label, args in probs.items():
        call = caller(torch, lib, args)
        for _ in range(5):  # the last call's marks are read
            marks.zero_()
            got = call()
        torch.cuda.synchronize()
        exact = all(torch.equal(x, y) for x, y in zip(got, cm.fused_masked_match_plain(*args)))
        m = marks.cpu().numpy()
        b, t = m[:16], m[32:]
        t = t[t[:, 0] > 0]
        d = lambda x, k: np.median(x[:, k] - x[:, 0]) / 1e3
        bin_line = ", ".join(f"{p} {d(b, k + 1) - d(b, k):.2f}" for k, p in enumerate(BIN_PHASES))
        first = t[t[:, 2] > 0]
        match_line = ", ".join(f"{p} {d(first, k + 1):.2f}" for k, p in enumerate(MATCH_PHASES))
        print(f"[phases] {label} (exact {exact}): mm_bin, us per phase (median over its 16 "
              f"blocks): {bin_line}; in all {d(b, 6):.2f}", flush=True)
        print(f"[phases] {label}: mm_match, us from a block's start to the end of (median over "
              f"the {len(first)} blocks with a first item; {len(t)} blocks): {match_line}; the "
              f"last block's item ends at {np.max(first[:, 5] - first[:, 0]) / 1e3:.2f}; it "
              f"starts {(np.median(t[:, 0]) - b[:, 6].max()) / 1e3:.2f} us after mm_bin's last "
              "block ends", flush=True)


def variants(torch, libs, probs) -> None:
    from torch.profiler import ProfilerActivity, profile
    from fishbirdeyevisualslam_torch.ops import cuda_matcher as cm
    for label, args in probs.items():
        ref = cm.fused_masked_match_plain(*args)
        for name, lib in libs.items():
            call = caller(torch, lib, args)
            got = call()
            torch.cuda.synchronize()
            exact = all(torch.equal(x, y) for x, y in zip(got, ref))
            if not exact and "diagnostic" not in name:
                raise SystemExit(f"variant {name} differs from the plain version ({label})")
            for _ in range(10):
                call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(30):
                    call()
                torch.cuda.synchronize()
            per = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    key = "mm_bin" if "mm_bin" in e.name else "mm_match"
                    per.setdefault(key, []).append(e.device_time)
            text = ", ".join(f"{k} {np.median(v):.2f} us" for k, v in sorted(per.items()))
            print(f"[variant] {label}, {name}{'' if exact else ' (not exact)'}: {text}",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS),
                    help=f"variants to time (default all): {list(VARIANTS)}")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    src = (ROOT / "fishbirdeyevisualslam_torch" / "csrc" / "hamming.cu").read_text()
    named = {"phases": with_marks(src)}
    named.update({v: edited(src, VARIANTS[v]) for v in args.variants})
    libs = build(named)
    probs = problems(torch, torch.device("cuda"))
    phases(torch, libs.pop("phases"), probs)
    variants(torch, libs, probs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
