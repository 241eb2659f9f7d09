#!/usr/bin/env python3
"""What each part of the rwkv6_scan_bwd kernel costs: the kernel's time
with that part taken out.

    python3 tools/ablate_rwkv6_scan_bwd.py [--source PATH/rwkv6_scan_bwd.cu]

Run from the root of a checkout, on a machine with one CUDA card.  It
builds the reverse scan's source (by default the checkout's
``csrc/rwkv6_scan_bwd.cu``) and, beside it under ``build/ablate/``, one
copy for each part below with that part's code skipped (the copies'
outputs are wrong; only their times are read), all with one ``nvcc``
each, started together.  Then it times every build at rwkv6-1.6b's
training shape (fp32 r/k/v/logw/dy (4, 512, 32, 64), checkpoints every 16
steps) with ``chip_smoke.py``'s ``time_ms`` (median of 20 calls, each
after a 256 MB L2 flush), in turns: all, then all in reverse order.  It
prints each build's two times and what taking the part out saves.

Parts: the products with S0 and G_end (HS, VG) of team A; Kin G_end; M
and A; the intra products (dr's and dk's against M); G's update; the Z
sums; the next tile's prep; dlogw.  A part whose code is gone stops the
script, naming it.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ablate"

SKIP = "if (tile < 0) "
# part: [(line of rwkv6_scan_bwd.cu, its replacement)]
PARTS = {
    "HS, VG": [
        ("      warp_mm_s<D / 8, 1, false, false, PD, 1, 1, PD>(\n          hs,",
         "      " + SKIP + "warp_mm_s<D / 8, 1, false, false, PD, 1, 1, PD>(\n"
         "          hs,"),
        ("      warp_mm_s<D / 8, 1, kEx, false, PVT, 1, 1, PD>(\n          vg,",
         "      " + SKIP + "warp_mm_s<D / 8, 1, kEx, false, PVT, 1, 1, PD>(\n"
         "          vg,")],
    "Kin G_end": [
        ("      warp_mm_s<kDi / 8, L::kNtv, false, false, PI, 1, PD, 1>(\n"
         "          dva,",
         "      " + SKIP + "warp_mm_s<kDi / 8, L::kNtv, false, false, PI, 1, "
         "PD, 1>(\n          dva,")],
    "M and A": [
        ("      if (L::kGroups >= 8) {\n        if (grp < 2) {",
         "      if (tile < 0 && L::kGroups >= 8) {\n        if (grp < 2) {"),
        ("      } else if (grp == 0) {\n        float mc[2][4];",
         "      } else if (tile < 0 && grp == 0) {\n        float mc[2][4];"),
        ("      } else if (grp == 1) {\n#pragma unroll\n        for (int blk = 0;",
         "      } else if (tile < 0 && grp == 1) {\n#pragma unroll\n        for "
         "(int blk = 0;")],
    "intra products": [
        ("      warp_mm<3, 1, false, false>(\n          ri,",
         "      " + SKIP + "warp_mm<3, 1, false, false>(\n          ri,"),
        ("      warp_mm<3, 1, false, false>(\n          ki,",
         "      " + SKIP + "warp_mm<3, 1, false, false>(\n          ki,")],
    "G's update": [
        ("#pragma unroll\n      for (int mt = 0; mt < kDi / 16; ++mt) {",
         "      for (int mt = 0; mt < kDi / 16 && tile < 0; ++mt) {")],
    "Z sums": [
        ("      switch (part) {", "      if (tile >= 0) {} else switch (part) {")],
    "prep": [
        ("      prep_tile<T, D>(smem + ((tile - 1) & 1) * L::kStage,",
         "      " + SKIP + "prep_tile<T, D>(smem + ((tile - 1) & 1) * L::kStage,")],
    "dlogw": [
        ("    // ---- phase 4: dlogw and du, 8 lanes a channel, two steps each "
         "--------\n    {",
         "    // ---- phase 4: dlogw and du, 8 lanes a channel, two steps each "
         "--------\n    if (tile >= 0) {} else {")],
}


def build(source: Path):
    """Write the copies, build every version at once; {name: library}."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    src = source.read_text()
    common = (source.parent / "common.cuh").read_text()
    versions = {"full": src}
    for part, subs in PARTS.items():
        text = src
        for line, new in subs:
            if text.count(line) != 1:
                sys.exit(f"ablate_rwkv6_scan_bwd.py: {part}: line not found "
                         f"once: {line!r}")
            text = text.replace(line, new)
        versions[part] = text
    jobs = {}
    for n, (name, text) in enumerate(versions.items()):
        d = OUT / f"v{n}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "rwkv6_scan_bwd.cu").write_text(text)
        (d / "common.cuh").write_text(common)
        lib = d / "rwkv6_scan_bwd.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(d / "rwkv6_scan_bwd.cu")], stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            sys.exit(f"ablate_rwkv6_scan_bwd.py: nvcc failed for {name}:\n{err}")
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=CSRC / "rwkv6_scan_bwd.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_rwkv6_scan_bwd.py: no CUDA device", file=sys.stderr)
        return 1
    libs = build(args.source.resolve())
    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms
    from repro_torch.kernels.ref import rwkv6_scan as plain
    from repro_torch.kernels.rwkv6_scan import _BWD_ARGTYPES

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; {args.source}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, d, chunk = 4, 512, 32, 64, 16
    r, k, v, dy = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   for _ in range(4))
    logw = -torch.exp(torch.randn((b, s, h, d), generator=gen, device="cuda")
                      * 0.5 - 1.0)
    u = torch.randn((h, d), generator=gen, device="cuda") * 0.1
    _, _, ck = plain(r, k, v, logw, u, chunk=chunk)
    outs = [torch.empty((b, s, h, d), device="cuda") for _ in range(4)]
    du = torch.empty((b, h, d), device="cuda")
    ptrs = [x.data_ptr() for x in (r, k, v, logw, u, ck, dy)]
    calls = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).rwkv6_scan_bwd
        fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
        calls[name] = (lambda fn=fn: fn(
            *ptrs, None, *(x.data_ptr() for x in outs), du.data_ptr(), 0, b, s,
            h, d, chunk, torch.cuda.current_stream().cuda_stream))
    times = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        times[name].append(time_ms(torch, calls[name]))
    full = sum(times["full"]) / 2
    for name, (t1, t2) in times.items():
        saved = full - (t1 + t2) / 2
        print(f"  {name}: {t1:.4f} / {t2:.4f} ms"
              + ("" if name == "full" else
                 f"; taken out saves {saved:.4f} ms ({saved / full:.3f})"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
