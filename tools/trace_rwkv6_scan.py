#!/usr/bin/env python3
"""Where the rwkv6_scan kernel spends its time, block by block.

    python3 tools/trace_rwkv6_scan.py [--source PATH/rwkv6_scan.cu]

Run from the root of a checkout, on a machine with one CUDA card.  It
builds an instrumented copy of the kernel's source (by default the
checkout's ``csrc/rwkv6_scan.cu``; ``--source`` takes another version of
the file, with its ``common.cuh`` beside it, e.g. the parent commit's from
``git archive``) under ``build/trace/`` and runs it once at the rwkv6
serve path's prefill (bf16 r/k/v (8, 512, 32, 64), logw f32) after a
256 MB L2 flush.  Thread 0 of every block (and in the warp-specialised
design the first producer thread) sums SM cycles (clock64) by phase, and
thread 0 reads the global timer and its SM's id at entry and exit.  It
prints, as medians over the blocks:

- cycles per 16-step tile (the unit both designs stage) and the life of
  the thread that owns the state;
- in the step-by-step design (a thread per state column), the share of
  the life spent waiting for staged inputs (the staging loop's loads and
  its barriers); in the warp-specialised design, the producer's shares
  (waiting for its cp.async copies, issuing the next, waiting for the
  consumers to free a buffer, the prep of decays and exponentials, the
  score partials) and the consumer's share waiting for a tile (the rest
  is its products);
- the kernel's span (global timer), the bytes it moves per second over
  that span, the most blocks resident on one SM at once and the warps
  that makes (of the 64 an SM holds).

The instrumented copy is made by inserting probes around lines of the
source; a probe whose line is gone stops the script, naming it.
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

# (probe put before the line, line of rwkv6_scan.cu, probe put after it).
# Slots: 0-3 and 5 the first producer thread's: waiting for staged inputs,
# issuing copies, waiting for a free buffer, prep, life; 4 the block's
# threads; 6-7 the
# consumer's (thread 0): waiting for a tile, life; 8 tiles; 9-10 global
# timer at entry and exit; 11 the SM.
PROBES = {
    "warp-specialised": [
        ("", "  float* Ksub = own + L::kKsub;\n",
         "long long c_wait = 0, c_issue = 0, c_empty = 0, c_prep = 0, t0_ = 0; "
         "const long long t_entry = clock64();"),
        ("t0_ = clock64();", "    cp_async_wait<kStages - 2>();\n", ""),
        ("", "    bar_sync(kBarPrep, L::kProd);   // the tile landed; Rt..Ksub "
             "are free\n", "c_wait += clock64() - t0_; t0_ = clock64();"),
        ("c_issue += clock64() - t0_; t0_ = clock64();",
         "    if (tile >= 2) bar_sync(kBarEmpty + pb, L::kThreads);   // buffer "
         "pb is free\n", "c_empty += clock64() - t0_; t0_ = clock64();"),
        ("c_prep += clock64() - t0_;",
         "    // ---- score partials over this warp's 16 channels "
         "--------------------\n", ""),
        ("if (tile == tiles - 1) { TVP(0, c_wait); TVP(1, c_issue); "
         "TVP(2, c_empty); TVP(3, c_prep); TVP(5, clock64() - t_entry); }",
         "    bar_arrive(kBarFull + pb, L::kThreads);\n", ""),
        ("", "  const int j0 = 16 * warp;                  // this warp's state "
             "columns\n",
         "long long c_full = 0, t1_ = 0; const long long t_entry = clock64(); "
         "GT(9); SMID(11); TV(4, blockDim.x);"),
        ("t1_ = clock64();", "    bar_sync(kBarFull + pb, L::kThreads);\n",
         "c_full += clock64() - t1_;"),
        ("TV(6, c_full); TV(7, clock64() - t_entry); TV(8, tiles); GT(10);",
         "  float* out = state + size_t(bh) * D * D;   // (b, h, i, j)\n", ""),
    ],
    "step by step": [
        ("", "  const size_t base = (size_t(b) * S * H + h) * D;    "
             "// element (b, 0, h, 0)\n",
         "long long c_wait = 0, t0_ = 0; const long long t_entry = clock64(); "
         "GT(9); SMID(11); TV(4, blockDim.x);"),
        ("t0_ = clock64();", "    __syncthreads();  // every read of the "
                             "previous chunk is done\n", ""),
        ("c_wait += clock64() - t0_;", "    if (j < n) {  // thread j: the "
                                       "bonus bracket of staged step j\n", ""),
        ("TV(0, c_wait); TV(5, clock64() - t_entry); TV(7, clock64() - t_entry); "
         "TV(8, (S + 15) / 16); GT(10);",
         "  float* out = state + size_t(bh) * D * D;  "
         "// (b, h, i, j): coalesced over j\n", ""),
    ],
}
PREAMBLE = """
__device__ long long g_trace[8192][12];
#define TV(i, v) do { if (threadIdx.x == 0) \\
  g_trace[blockIdx.x][i] = (long long)(v); } while (0)
#define TVP(i, v) do { if (threadIdx.x == L::kCons) \\
  g_trace[blockIdx.x][i] = (long long)(v); } while (0)
#define GT(i) do { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); TV(i, t_); } while (0)
#define SMID(i) do { unsigned s_; \\
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s_)); TV(i, s_); } while (0)
"""
EXPORTS = """
BPD_EXPORT int get_trace(void* dst) {
  return cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
"""


def instrument(source: Path):
    src = source.read_text()
    design = "warp-specialised" if "kBarFull" in src else "step by step"
    src = src.replace('#include "common.cuh"\n',
                      '#include "common.cuh"\n' + PREAMBLE, 1)
    for before, line, after in PROBES[design]:
        if line not in src:
            sys.exit(f"trace_rwkv6_scan.py: probe line not found: {line!r}")
        src = src.replace(line, f"  {before}\n{line}  {after}\n", 1)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "rwkv6_scan.cu").write_text(src + EXPORTS)
    (OUT / "common.cuh").write_text((source.parent / "common.cuh").read_text())
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    lib = OUT / "rwkv6_scan_trace.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(OUT / "rwkv6_scan.cu")], check=True)
    return lib, design


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
    ap.add_argument("--source", type=Path, default=CSRC / "rwkv6_scan.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_rwkv6_scan.py: no CUDA device", file=sys.stderr)
        return 1
    path, design = instrument(args.source.resolve())
    lib = ctypes.CDLL(str(path))
    from repro_torch.kernels.rwkv6_scan import _ARGTYPES

    fn = lib.rwkv6_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; {args.source} ({design} design)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    b, s, h, d = 8, 512, 32, 64
    r, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    logw = -torch.exp(torch.randn((b, s, h, d), generator=gen, device="cuda")
                      * 0.5 - 1.0)
    u = torch.randn((h, d), generator=gen, device="cuda") * 0.1
    y = torch.empty((b, s, h, d), device="cuda")
    state = torch.empty((b, h, d, d), device="cuda")
    for _ in range(4):                               # the last call is read
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(), y.data_ptr(), state.data_ptr(), 1, b, s, h, d,
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            print(f"launch failed: CUDA error {err}", file=sys.stderr)
            return 1
    trace = np.zeros((8192, 12), dtype=np.int64)
    lib.get_trace(ctypes.c_void_p(trace.ctypes.data))
    t = trace[:b * h]
    med = lambda x: float(np.median(x))               # noqa: E731
    life = t[:, 7].astype(np.float64)                 # the state's owner
    tiles = int(t[0, 8])
    print(f"{len(t)} blocks; life {med(life):.0f} cycles, "
          f"{med(life / tiles):.0f} cycles a 16-step tile ({tiles} tiles)")
    if design == "warp-specialised":
        plife = t[:, 5].astype(np.float64)
        parts = {"waiting for staged inputs": t[:, 0], "issuing copies": t[:, 1],
                 "waiting for a free buffer": t[:, 2], "prep": t[:, 3],
                 "score partials and hand-over": plife - t[:, :4].sum(axis=1)}
        print("  producer, share of its life: " + ", ".join(
            f"{name} {med(c / plife):.3f}" for name, c in parts.items()))
        print(f"  consumer, share of its life waiting for a tile: "
              f"{med(t[:, 6] / life):.3f} (products {med(1 - t[:, 6] / life):.3f})")
    else:
        print(f"  share of life waiting for staged inputs: {med(t[:, 0] / life):.3f}")
    warps = int(t[0, 4]) // 32
    start, end = t[:, 9], t[:, 10]
    span_ns = end.max() - start.min()
    moved = (sum(x.numel() * x.element_size() for x in (r, k, v, logw, u))
             + (y.numel() + state.numel()) * 4)
    most = most_resident(t[:, 11], start, end)
    print(f"  span {span_ns / 1e3:.2f} us, {moved / span_ns:.0f} GB/s; blocks "
          f"live {med(end - start) / 1e3:.2f} us (median); at most {most} "
          f"blocks on one SM at once: {most * warps} of 64 warps "
          f"({most * warps / 64:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
