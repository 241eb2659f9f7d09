#!/usr/bin/env python3
"""Where the fused-verify kernel spends its time, block by block.

    python3 tools/trace_fused_verify.py

Run from the root of a checkout, on a machine with one CUDA card.  It
builds an instrumented copy of ``csrc/fused_verify.cu`` under
``build/trace/`` in which thread 0 of every block reads the global timer
at entry, when its last range's loads are done, when its last partial is
ready, around the first cluster.sync() (partials in place), before the
second (rank 0 done: merge, compare, scan) and at exit.  It runs the
kernel at the decode path's shape (bf16 p1 logits (8, 8, 49408), exact)
after a 256 MB L2 flush and prints, since the first block's entry, each
point's median over the blocks and its latest; then the event-timed call
as ``chip_smoke.py`` times it (cold L2), the same timer around a
one-element ``fill_`` (what the timer reads for the least kernel), and the
time a call takes with the logits in L2 (100 calls in a row, replayed as
one CUDA graph), as the decode path finds them right after the projection
that wrote them.

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

# (probe put before the line, line of fused_verify.cu, probe put after it)
PROBES = [
    ("", "  const int tid = threadIdx.x;\n", "GT(0);"),
    ("", "  if (tid < hi - tail) top.insert(to_f32(row[tail + tid]), tail + tid);\n",
     "GT(1);"),
    ("", "    if (tid == 0) top.store(part_v + n * TT, part_i + n * TT);\n",
     "GT(2);"),
    ("", "  cluster.sync();   // every partial of the row is in its block's "
         "memory\n", "GT(3);"),
    ("GT(4);", "  cluster.sync();   // no block leaves while rank 0 reads its "
               "partials\n", "GT(5);"),
]
POINTS = ("loads done", "partial ready", "past cluster.sync 1",
          "rank 0 done", "exit")
PREAMBLE = """
__device__ long long g_trace[4096][6];
#define GT(i) do { if (threadIdx.x == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
  g_trace[blockIdx.x][i] = (long long)t_; } } while (0)
"""
EXPORTS = """
BPD_EXPORT int get_trace(void* dst) {
  return cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
"""


def instrument() -> Path:
    src = (CSRC / "fused_verify.cu").read_text()
    src = src.replace('#include "common.cuh"\n',
                      '#include "common.cuh"\n' + PREAMBLE, 1)
    for before, line, after in PROBES:
        if line not in src:
            sys.exit(f"trace_fused_verify.py: probe line not found: {line!r}")
        src = src.replace(line, f"  {before}\n{line}  {after}\n", 1)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "fused_verify.cu").write_text(src + EXPORTS)
    (OUT / "common.cuh").write_text((CSRC / "common.cuh").read_text())
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    lib = OUT / "fused_verify_trace.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(OUT / "fused_verify.cu")], check=True)
    return lib


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("trace_fused_verify.py: no CUDA device", file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(instrument()))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms
    from repro_torch.kernels.fused_verify import (_ARGTYPES, fused_verify_cuda,
                                                  verify_plan)

    fn = lib.fused_verify
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    b, k, vp = 8, 8, 49408
    logits = torch.randn((b, k, vp), generator=gen, device="cuda").bfloat16()
    props = torch.randint(0, vp, (b, k), generator=gen, device="cuda",
                          dtype=torch.int32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cluster, ranges = verify_plan(vp, b, k, sms)
    outs = [torch.empty((b, k), dtype=torch.bool, device="cuda")] + [
        torch.empty(n, dtype=torch.int32, device="cuda") for n in ((b,), (b, k), (b,))]
    for _ in range(4):                               # the last call is read
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        err = fn(logits.data_ptr(), props.data_ptr(),
                 *(o.data_ptr() for o in outs), 1, b, k, vp, 1, 0, 0.0,
                 cluster, ranges, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            print(f"launch failed: CUDA error {err}", file=sys.stderr)
            return 1
    trace = np.zeros((4096, 6), dtype=np.int64)
    lib.get_trace(ctypes.c_void_p(trace.ctypes.data))
    t = trace[:b * cluster]
    since = (t[:, 1:] - t[:, 0].min()) / 1e3
    print(f"bf16 logits ({b}, {k}, {vp}), exact: {b} clusters of {cluster} "
          f"blocks, {ranges} range(s) a slot; microseconds since the first "
          f"block's entry, median / latest block:")
    print("  " + ", ".join(f"{p} {np.median(c):.2f} / {c.max():.2f}"
                           for p, c in zip(POINTS, since.T)))

    def call():
        fused_verify_cuda(logits, props, criterion="exact")

    cold = time_ms(torch, call)
    one = torch.empty(1, device="cuda")
    floor = time_ms(torch, lambda: one.fill_(1.0))
    graph = torch.cuda.CUDAGraph()                   # 100 calls, one launch
    call()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        for _ in range(100):
            call()
    graph.replay()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    print(f"  event-timed call {cold:.4f} ms (cold L2); the timer around a "
          f"one-element fill_ {floor:.4f} ms; logits in L2: "
          f"{start.elapsed_time(stop) / 100:.4f} ms a call (100 in a row, one "
          f"graph)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
