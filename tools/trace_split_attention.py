#!/usr/bin/env python3
"""Where the split-KV attention kernel spends its time, block by block.

    python3 tools/trace_split_attention.py

Run from the root of a checkout, on a machine with one CUDA card.  It
builds an instrumented copy of ``csrc/verify_attention.cu`` and its header
under ``build/trace/``: thread 0 of every block reads the SM clock at seven
points and the global timer at entry and exit.  Then it runs bf16
``verify_attention`` after a 256 MB L2 flush at the serve path's shape (B 8,
H 32, KV 8, hd 128, L 256; kq 8 and 1) and at L 4096, and prints:

- the median and largest cycles since the block's entry at each point:
  copies issued, first tile landed, tile loop done, partials written,
  cluster barrier passed, outputs written, second barrier passed;
- the kernel's span, how far apart its blocks started, and how long they
  lived (global timer, us);
- the blocks per SM and clusters the runtime can hold at once.

The instrumented copy is made by inserting probes after lines of the
source; a probe whose line is gone stops the script, naming it.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "trace"

# (probe put before the line, line of split_attention.cuh, probe put after
# it); TR(i) stores the SM clock of thread 0 in slot i, GT(i) the global timer
PROBES = [
    ("", "  const int n_tiles = (k_end - k_begin + kKeys - 1) / kKeys;\n",
     "GT(8); TR(0);"),
    ("", "  load_tile(0, k_begin);\n  cp_async_commit();\n", "TR(1);"),
    ("", "        cp_async_wait<0>();\n      }\n      __syncthreads();\n",
     "if (it == 0) TR(2);"),
    ("", "      __syncthreads();   // the tile is no longer read; the next one "
         "may land\n    }\n", "TR(3);"),
    ("TR(4);", "  cluster.sync();\n  const float* rp[kMaxSplits];\n", "TR(5);"),
    ("TR(6);", "  cluster.sync();      // no block leaves while another reads "
               "its partials\n", "TR(7); GT(9);"),
]
PREAMBLE = """
__device__ unsigned long long g_trace[8192][10];
#define TR(i) do { if (threadIdx.x == 0) g_trace[blockIdx.x][i] = clock64(); } while (0)
#define GT(i) do { if (threadIdx.x == 0) { unsigned long long t; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); g_trace[blockIdx.x][i] = t; } } while (0)
"""
EXPORTS = """
BPD_EXPORT int get_trace(void* dst) {
  return cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
BPD_EXPORT int occupancy(int splits, int* per_sm, int* clusters) {
  using Lay = bpd_split::Layout<__nv_bfloat16, 128, false>;
  auto kernel = bpd_split::split_attention_kernel<__nv_bfloat16, 128,
                                                  bpd_split::DenseRows, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lay::kBytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, 128,
                                                      Lay::kBytes);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(64 * splits);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = Lay::kBytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}
"""
POINTS = ["issued", "landed", "loop done", "partials", "barrier", "outputs",
          "barrier 2"]


def instrument() -> Path:
    src = (CSRC / "split_attention.cuh").read_text()
    src = src.replace("#pragma once", "#pragma once\n" + PREAMBLE, 1)
    for before, line, after in PROBES:
        if line not in src:
            sys.exit(f"trace_split_attention.py: probe line not found: {line!r}")
        src = src.replace(line, f"  {before}\n{line}  {after}\n", 1)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "split_attention.cuh").write_text(src)
    (OUT / "common.cuh").write_text((CSRC / "common.cuh").read_text())
    (OUT / "verify_attention.cu").write_text(
        (CSRC / "verify_attention.cu").read_text() + EXPORTS)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    lib = OUT / "verify_attention_trace.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(OUT / "verify_attention.cu")], check=True)
    return lib


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("trace_split_attention.py: no CUDA device", file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(instrument()))
    from repro_torch.kernels.block_attention import _ARGTYPES, split_plan

    fn = lib.verify_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    for splits in sorted({split_plan(256)[0], split_plan(4096)[0]}):
        per_sm, clusters = ctypes.c_int(), ctypes.c_int()
        err = lib.occupancy(splits, ctypes.byref(per_sm), ctypes.byref(clusters))
        print(f"occupancy (bf16, hd 128): {per_sm.value} blocks per SM, "
              f"{clusters.value} clusters of {splits} at once (rc {err})")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    b, h, kvh, hd = 8, 32, 8, 128
    for l, kq in ((256, 8), (256, 1), (4096, 8)):
        q = torch.randn((b, kq, h, hd), generator=gen, device="cuda").bfloat16()
        k = torch.randn((b, l, kvh, hd), generator=gen, device="cuda").bfloat16()
        v = torch.randn_like(k)
        q_pos = (l - kq + torch.arange(kq, device="cuda")).int()[None].repeat(b, 1)
        kv_pos = torch.arange(l, device="cuda").int()[None].repeat(b, 1)
        out = torch.empty_like(q)
        splits = split_plan(l)[0]
        for _ in range(4):                       # the last call is read
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                     kv_pos.data_ptr(), out.data_ptr(), 1, b, kq, h, kvh, hd, l,
                     0, 0, splits, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                print(f"launch failed: CUDA error {err}", file=sys.stderr)
                return 1
        trace = np.zeros((8192, 10), dtype=np.uint64)
        lib.get_trace(ctypes.c_void_p(trace.ctypes.data))
        t = trace[:b * kvh * splits].astype(np.int64)
        cycles = t[:, 1:8] - t[:, [0]]
        print(f"L {l}, kq {kq}: {splits} splits, {len(t)} blocks")
        print("  cycles since entry, median: " + ", ".join(
            f"{p} {int(c)}" for p, c in zip(POINTS, np.median(cycles, axis=0))))
        print("  cycles since entry, largest: " + ", ".join(
            f"{p} {int(c)}" for p, c in zip(POINTS, cycles.max(axis=0))))
        start, end = t[:, 8], t[:, 9]
        print(f"  span {(end.max() - start.min()) / 1e3:.2f} us, starts spread "
              f"over {(start.max() - start.min()) / 1e3:.2f} us, blocks live "
              f"{np.median(end - start) / 1e3:.2f} us (median), "
              f"{(end - start).max() / 1e3:.2f} us (longest)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
