#!/usr/bin/env python3
"""Where the fused-heads kernel spends its time, block by block.

    python3 tools/trace_fused_heads.py

Run from the root of a checkout, on a machine with one CUDA card.  It
builds an instrumented copy of ``csrc/fused_heads.cu`` under
``build/trace/``: in every persistent block, consumer thread 0 sums the SM
cycles it waits for a stage to land (full barrier), the cycles of the
tiles' fold (logits to shared memory, top-T update) and its whole life,
and in fp32 (thread 0 is in the first of two consumer warpgroups) also the cycles it spends loading and splitting W's fragments
into TF32 parts and issuing the products and waiting for them
(wgmma.wait_group); the producer thread sums the cycles it waits for a
free stage (empty barrier).  Then it runs the kernel after a 256 MB L2
flush at the decode paths' shapes (bf16: granite-3-8b's tied (4096,
49408) table view and rwkv6-1.6b's (2048, 65536) row-major lm_head; fp32:
granite's tied view and nemotron-4-15b's (6144, 256000) row-major
lm_head; 56 rows, T 1 and 8) and prints, as medians over the blocks:

- the consumers' share of cycles waiting for data (high: the copies are
  late, the kernel waits on memory), splitting and issuing products
  (fp32) and folding;
- the producer's share waiting for a free stage (high: the products and
  the fold hold the ring back);
- cycles per stage, the kernel's span (global timer) and the bytes of w
  it read per second.

The instrumented copy is made by inserting probes around lines of the
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

# (probe put before the line, line of fused_heads.cu, probe put after it)
PROBES = [
    ("", "  const int ksteps = (d + kDepth - 1) / kDepth;\n",
     "long long c_wait = 0, p_wait = 0, fold = 0, t_fold = 0, split = 0, "
     "prod = 0; const long long t_entry = clock64(); GT(6);"),
    ("{ const long long w0_ = clock64();",
     "          mbar_wait(empty0 + 8 * stage, phase ^ 1u);\n",
     "p_wait += clock64() - w0_; }"),
    ("if (lane == 0) { TV(3, p_wait); TV(4, clock64() - t_entry); }",
     "    return;\n  }\n\n  // ---- consumers: warpgroups of wgmma "
     "products, then the fold ---------\n", ""),
    ("{ const long long w0_ = clock64();",
     "      mbar_wait(full0 + 8 * stage, phase);\n",
     "c_wait += clock64() - w0_; }"),
    # fp32: W's fragments loaded and split, then the products issued and
    # waited for (the fp32 branch comes first in the source)
    ("{ const long long s0_ = clock64();",
     "          load_split<kRowMajor>(ws, kc, wg, wq, g, t4, hi, lo);\n",
     "split += clock64() - s0_; }"),
    ("const long long p0_ = clock64();",
     "          wgmma_fence();   // A's registers written before the products "
     "read them\n", ""),
    ("", "          wgmma_wait<1>();   // the 8-deep step before this one is "
     "done\n", "prod += clock64() - p0_;"),
    ("{ const long long p1_ = clock64();", "        wgmma_wait<0>();\n",
     "prod += clock64() - p1_; }"),
    ("t_fold = clock64();",
     "    // the tile's logits into shared memory, [row][lane] (the "
     "accumulator\n", ""),
    ("", "    consumer_sync<S::kConsumers>();   // lg is free for the next "
     "tile\n",
     "fold += clock64() - t_fold;"),
    ("if (tid == 0) { TV(0, c_wait); TV(1, fold); TV(2, clock64() - t_entry); "
     "TV(5, (long long)(t_end - t_begin) * ksteps); TV(8, split); "
     "TV(9, prod); } GT(7);",
     "  // each row's kWays lists merge into the block's partial for that row\n",
     ""),
]
PREAMBLE = """
__device__ long long g_trace[8192][10];
#define TV(i, v) (g_trace[blockIdx.x + gridDim.x * blockIdx.y][i] = (v))
#define GT(i) do { if (threadIdx.x == 0) { unsigned long long t; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); TV(i, (long long)t); } } while (0)
"""
EXPORTS = """
BPD_EXPORT int get_trace(void* dst) {
  return cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
"""
SLOTS = ("consumer wait", "fold", "consumer life", "producer wait",
         "producer life", "stages", "start", "end", "split", "products")


def instrument() -> Path:
    src = (CSRC / "fused_heads.cu").read_text()
    src = src.replace('#include "common.cuh"\n',
                      '#include "common.cuh"\n' + PREAMBLE, 1)
    for before, line, after in PROBES:
        if line not in src:
            sys.exit(f"trace_fused_heads.py: probe line not found: {line!r}")
        src = src.replace(line, f"  {before}\n{line}  {after}\n", 1)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "fused_heads.cu").write_text(src + EXPORTS)
    (OUT / "common.cuh").write_text((CSRC / "common.cuh").read_text())
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    lib = OUT / "fused_heads_trace.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(OUT / "fused_heads.cu")], check=True)
    return lib


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("trace_fused_heads.py: no CUDA device", file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(instrument()))
    from repro_torch.kernels.fused_heads import _ARGTYPES, vocab_plan

    fn = lib.fused_heads_topk
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"card: {card}, {sms} SMs")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    n = 56
    for name, dt, d, vp, vocab, tied in (
            ("granite tied", torch.bfloat16, 4096, 49408, 49155, True),
            ("rwkv6 row-major", torch.bfloat16, 2048, 65536, 65536, False),
            ("granite tied", torch.float32, 4096, 49408, 49155, True),
            ("nemotron row-major", torch.float32, 6144, 256000, 256000,
             False)):
        fp32 = dt == torch.float32
        o = torch.randn((n, d), generator=gen, device="cuda").to(dt)
        if tied:
            w = torch.randn((vp, d), generator=gen, device="cuda").to(dt).t()
        else:
            w = torch.randn((d, vp), generator=gen, device="cuda").to(dt)
        split = torch.empty((2, n, d), device="cuda") if fp32 else None
        blocks, tiles = vocab_plan(vp, sms)
        for top_t in (1, 8):
            part_v = torch.empty((n, blocks, top_t), device="cuda")
            part_i = torch.empty((n, blocks, top_t), dtype=torch.int32,
                                 device="cuda")
            vals = torch.empty((n, top_t), device="cuda")
            ids = torch.empty((n, top_t), dtype=torch.int32, device="cuda")
            for _ in range(4):                       # the last call is read
                flush.zero_()
                torch.cuda._sleep(2_000_000)
                err = fn(o.data_ptr(), w.data_ptr(),
                         None if split is None else split.data_ptr(),
                         part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
                         ids.data_ptr(), *w.stride(), 0 if fp32 else 1, n, d,
                         vp, vocab, top_t, blocks,
                         torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                if err:
                    print(f"launch failed: CUDA error {err}", file=sys.stderr)
                    return 1
            trace = np.zeros((8192, len(SLOTS)), dtype=np.int64)
            lib.get_trace(ctypes.c_void_p(trace.ctypes.data))
            t = trace[:blocks]
            med = dict(zip(SLOTS, np.median(t, axis=0)))
            life = med["consumer life"]
            span_ns = t[:, 7].max() - t[:, 6].min()
            dtype = "fp32" if fp32 else "bf16"
            print(f"{dtype} {name} ({n}, {d}) x ({d}, {vp}), T {top_t}: "
                  f"{blocks} blocks over {tiles} tiles of 128 lanes")
            products = (f"loading and splitting W {med['split'] / life:.3f}, "
                        f"issuing and waiting for products "
                        f"{med['products'] / life:.3f}, " if fp32 else "")
            print(f"  consumers: waiting for data "
                  f"{med['consumer wait'] / life:.3f}, {products}folding "
                  f"{med['fold'] / life:.3f} of {int(life)} cycles; producer "
                  f"waiting for a free stage "
                  f"{med['producer wait'] / med['producer life']:.3f} of "
                  f"{int(med['producer life'])}")
            print(f"  {life / med['stages']:.0f} cycles a stage "
                  f"({int(med['stages'])} stages a block); span "
                  f"{span_ns / 1e3:.2f} us, starts spread over "
                  f"{(t[:, 6].max() - t[:, 6].min()) / 1e3:.2f} us; w read at "
                  f"{w.numel() * w.element_size() / span_ns:.0f} GB/s")
        del o, w, split
    return 0


if __name__ == "__main__":
    sys.exit(main())
