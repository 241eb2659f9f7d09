#!/usr/bin/env python3
"""Where the rwkv6_scan_bwd kernel spends its time, phase by phase.

    python3 tools/trace_rwkv6_scan_bwd.py [--source PATH/rwkv6_scan_bwd.cu]

Run from the root of a checkout, on a machine with one CUDA card.  It
builds an instrumented copy of the reverse scan's source (by default the
checkout's ``csrc/rwkv6_scan_bwd.cu``; ``--source`` takes another version
with the same phase comments, its ``common.cuh`` beside it) under
``build/trace/`` and runs it once at rwkv6-1.6b's training shape (fp32 r/k/v
/logw/dy (4, 512, 32, 64), checkpoints every 16 steps) after a 256 MB L2
flush.  Three threads of every block sum SM cycles (clock64) by phase of
the tile loop: thread 0 (team A: the products with S0 and G_end, dr / dk,
the Z sums) and the first threads of team B's first two warps (Kin G_end
with one of M's n tiles; dv and G's update; the next tile's prep).  For each it prints,
as medians over the blocks and per 16-step tile, the cycles spent waiting
at the top of a tile for its inputs, issuing copies, working in each of
the four phases and waiting at the barrier after each (clock64 is
read where the probes stand, but the compiler may move other work across
a probe: a slot's cycles are its region's, roughly); then the kernel's
span (global timer), the bytes it moves per second over that span and
the most blocks resident on one SM at once.

The instrumented copy is made by inserting probes at lines of the source;
a probe whose line is gone stops the script, naming it.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "trace"

SLOTS = ("top wait", "phase 1", "barrier 1", "phase 2", "barrier 2",
         "phase 3", "barrier 3", "phase 4", "stage copies", "S0 copies")
# (line of rwkv6_scan_bwd.cu, its replacement with probes)
PROBES = [
    ("  float du_acc = 0.f;\n",
     "  float du_acc = 0.f;\n  long long tp_ = clock64(), acc_[10] = {}; "
     "const long long t_entry = clock64(); GT(33);\n"),
    ("    __syncthreads();   // the tile's start state landed; its prep and the "
     "last tile are done\n",
     "    __syncthreads();   // the tile's start state landed; its prep and the "
     "last tile are done\n    TP(0);\n"),
    ("    // ---- S0 past a chunk's first tile: replayed from the checkpoint "
     "------\n",
     "    TP(8);\n    // ---- S0 past a chunk's first tile: replayed from the "
     "checkpoint ------\n"),
    ("    __syncthreads();\n    if (tile > 0) {             // S0's last readers "
     "are done\n",
     "    TP(1); __syncthreads(); TP(2);\n    if (tile > 0) {             "
     "// S0's last readers are done\n"),
    ("    // ---- phase 2: team A dr, dk out; team B dv out and G's update "
     "--------\n",
     "    TP(9);\n    // ---- phase 2: team A dr, dk out; team B dv out and G's "
     "update --------\n"),
    ("    cp_async_wait<1>();   // this thread's copies of the next tile's inputs "
     "landed\n    __syncthreads();\n",
     "    TP(3); cp_async_wait<1>(); __syncthreads(); TP(4);\n"),
    ("    __syncthreads();\n\n    // ---- phase 4: dlogw and du, 8 lanes a "
     "channel, two steps each --------\n",
     "    TP(5); __syncthreads(); TP(6);\n\n    // ---- phase 4: dlogw and du, 8 "
     "lanes a channel, two steps each --------\n"),
    ("  }\n  du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 1);\n",
     "    TP(7);\n  }\n  RECORD(t_entry, tiles);\n  du_acc += "
     "__shfl_xor_sync(0xffffffffu, du_acc, 1);\n"),
]
PREAMBLE = """
__device__ long long g_trace[8192][40];   // 3 x 10 slots, then 30-37
#define TP(k) do { const long long n_ = clock64(); acc_[k] += n_ - tp_; \\
  tp_ = n_; } while (0)
#define GT(i) do { if (threadIdx.x == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
  g_trace[blockIdx.x][i] = (long long)t_; } } while (0)
#define RECORD(entry, tiles) do { \\
  const int rec_ = threadIdx.x == 0 ? 0 \\
      : threadIdx.x == 32 * L::kGroups ? 1 \\
      : threadIdx.x == 32 * L::kGroups + 32 ? 2 : -1; \\
  if (rec_ >= 0) { \\
    for (int k_ = 0; k_ < 10; ++k_) g_trace[blockIdx.x][10 * rec_ + k_] = acc_[k_]; \\
    g_trace[blockIdx.x][30 + rec_] = clock64() - (entry); } \\
  if (threadIdx.x == 0) { unsigned s_; \\
    asm volatile("mov.u32 %0, %%smid;" : "=r"(s_)); \\
    g_trace[blockIdx.x][35] = s_; g_trace[blockIdx.x][36] = (tiles); \\
    g_trace[blockIdx.x][37] = blockDim.x; } \\
  GT(34); } while (0)
"""
EXPORTS = """
BPD_EXPORT int get_trace(void* dst) {
  return cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
"""


def instrument(source: Path) -> Path:
    src = source.read_text()
    src = src.replace('#include "common.cuh"\n',
                      '#include "common.cuh"\n' + PREAMBLE, 1)
    for line, new in PROBES:
        if line not in src:
            sys.exit(f"trace_rwkv6_scan_bwd.py: probe line not found: {line!r}")
        src = src.replace(line, new, 1)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "rwkv6_scan_bwd.cu").write_text(src + EXPORTS)
    (OUT / "common.cuh").write_text((source.parent / "common.cuh").read_text())
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    lib = OUT / "rwkv6_scan_bwd_trace.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(OUT / "rwkv6_scan_bwd.cu")], check=True)
    return lib


def most_resident(sm, start, end) -> int:
    """The most blocks live on one SM at once (global-timer intervals)."""
    best = 0
    for s in set(sm.tolist()):
        ev = sorted([(t, 1) for t in start[sm == s]]
                    + [(t, -1) for t in end[sm == s]], key=lambda e: (e[0], e[1]))
        live = 0
        for _, d in ev:
            live += d
            best = max(best, live)
    return best


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=CSRC / "rwkv6_scan_bwd.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_rwkv6_scan_bwd.py: no CUDA device", file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(instrument(args.source.resolve())))
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.ref import rwkv6_scan as plain
    from repro_torch.kernels.rwkv6_scan import _BWD_ARGTYPES, bwd_splits

    fn = lib.rwkv6_scan_bwd
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; {args.source}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    b, s, h, d, chunk = 4, 512, 32, 64, 16
    r, k, v, dy = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   for _ in range(4))
    logw = -torch.exp(torch.randn((b, s, h, d), generator=gen, device="cuda")
                      * 0.5 - 1.0)
    u = torch.randn((h, d), generator=gen, device="cuda") * 0.1
    _, _, ck = plain(r, k, v, logw, u, chunk=chunk)
    outs = [torch.empty((b, s, h, d), device="cuda") for _ in range(4)]
    du = torch.empty((b, h, d), device="cuda")
    for _ in range(4):                               # the last call is read
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        err = fn(*(x.data_ptr() for x in (r, k, v, logw, u, ck, dy)), None,
                 *(x.data_ptr() for x in outs), du.data_ptr(), 0, b, s, h, d,
                 chunk, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            print(f"launch failed: CUDA error {err}", file=sys.stderr)
            return 1
    trace = np.zeros((8192, 40), dtype=np.int64)
    lib.get_trace(ctypes.c_void_p(trace.ctypes.data))
    t = trace[:b * h * bwd_splits(d)].astype(np.float64)
    tiles = int(t[0, 36])
    med = lambda x: float(np.median(x))               # noqa: E731
    print(f"{len(t)} blocks of {int(t[0, 37])} threads, {tiles} tiles each; "
          f"cycles a tile, median over the blocks:")
    for rec, name in enumerate(("team A (thread 0)", "team B's first warp",
                                "team B's second warp")):
        row = t[:, 10 * rec:10 * rec + 10] / tiles
        print(f"  {name}: life {med(t[:, 30 + rec] / tiles):.0f}; " + ", ".join(
            f"{slot} {med(row[:, j]):.0f}" for j, slot in enumerate(SLOTS)))
    start, end = t[:, 33], t[:, 34]
    span_ns = end.max() - start.min()
    moved = (sum(x.numel() * x.element_size() for x in (r, k, v, logw, u, ck, dy))
             + sum(x.numel() * 4 for x in outs) + h * d * 4)
    most = most_resident(t[:, 35], start, end)
    print(f"  span {span_ns / 1e3:.2f} us, {moved / span_ns:.0f} GB/s; blocks "
          f"live {med(end - start) / 1e3:.2f} us (median); at most {most} "
          f"blocks on one SM at once")
    return 0


if __name__ == "__main__":
    sys.exit(main())
