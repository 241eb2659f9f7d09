#!/usr/bin/env python3
"""How far the fused-heads kernel's fp32 logits drift when the tensor
cores sum a whole vocab tile in one accumulator.

    python3 tools/fused_heads_accumulation.py

Run from the root of a checkout, on a machine with one CUDA card.  The
fp32 body sums each 32-deep stage's TF32 products into a fresh wgmma
accumulator and adds that into the tile's logits in fp32 registers.  This
builds, under ``build/accumulation/``, a copy of ``csrc/fused_heads.cu``
whose products instead accumulate across every stage of the tile (the
accumulator never restarted), beside the kernel as it is, and prints for
each the largest error of the top-8 values against the plain version
(``kernels/ref.py``, cuBLAS in fp32 with TF32 off) and against float64
logits, at 56 rows and the decode paths' depths (d 1600 to 7168; w drawn
at 0.02 as ``chip_smoke.py`` draws it).  The copy is made by replacing
two lines of the source; a line that is gone stops the script, naming it.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "accumulation"

# (line of fused_heads.cu, its replacement): one accumulator for the tile
EDITS = [
    ("wgmma_m64n64k8_tf32(part[0], lo, b_hi, kc > 0);",
     "wgmma_m64n64k8_tf32(part[0], lo, b_hi, ks + kc > 0);"),
    ("for (int i = 0; i < 32; ++i) acc[0][i] += part[0][i];",
     "for (int i = 0; i < 32; ++i) acc[0][i] = part[0][i];"),
]
SHAPES = (("hymba row-major", 1600, 32256, 32001, False),
          ("rwkv6 row-major", 2048, 65536, 65536, False),
          ("granite tied", 4096, 49408, 49155, True),
          ("nemotron row-major", 6144, 256000, 256000, False),
          ("llava row-major", 7168, 64000, 64000, False))


def build(text: str, name: str) -> Path:
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "common.cuh").write_text((CSRC / "common.cuh").read_text())
    (OUT / f"{name}.cu").write_text(text)
    lib = OUT / f"{name}.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(OUT / f"{name}.cu")], check=True)
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fused_heads_accumulation.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    src = (CSRC / "fused_heads.cu").read_text()
    whole = src
    for line, new in EDITS:
        if line not in whole:
            sys.exit(f"fused_heads_accumulation.py: line not found: {line!r}")
        whole = whole.replace(line, new, 1)
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.fused_heads import _ARGTYPES, vocab_plan

    fns = {}
    for name, text in (("per-stage", src), ("whole-tile", whole)):
        fn = ctypes.CDLL(str(build(text, name))).fused_heads_topk
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        fns[name] = fn
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, top_t = 56, 8
    for label, d, vp, vocab, tied in SHAPES:
        o = torch.randn((n, d), generator=gen, device="cuda")
        if tied:
            w = (torch.randn((vp, d), generator=gen, device="cuda") * 0.02).t()
        else:
            w = torch.randn((d, vp), generator=gen, device="cuda") * 0.02
        want_v, want_i = ref.heads_topk(o, w, vocab=vocab, top_t=top_t)
        blocks, _ = vocab_plan(vp, _build.sm_count(o.device))
        split = torch.empty((2, n, d), device="cuda")
        part_v = torch.empty((n, blocks, top_t), device="cuda")
        part_i = torch.empty((n, blocks, top_t), dtype=torch.int32,
                             device="cuda")
        out = []
        for name, fn in fns.items():
            vals = torch.empty((n, top_t), device="cuda")
            ids = torch.empty((n, top_t), dtype=torch.int32, device="cuda")
            err = fn(o.data_ptr(), w.data_ptr(), split.data_ptr(),
                     part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
                     ids.data_ptr(), *w.stride(), 0, n, d, vp, vocab, top_t,
                     blocks, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                print(f"launch failed: CUDA error {err}", file=sys.stderr)
                return 1
            cols = w.t()[ids.long()].double()          # (n, top_t, d)
            exact = (o.double()[:, None, :] * cols).sum(-1)
            out.append(f"{name}: {(vals - want_v).abs().max().item():.3g} "
                       f"from the plain version, "
                       f"{(vals.double() - exact).abs().max().item():.3g} "
                       f"from float64, ids equal {torch.equal(ids, want_i)}")
        top = want_v.abs().max().item()
        print(f"{label} ({n}, {d}) x ({d}, {vp}), max top-8 |logit| "
              f"{top:.3g}: " + "; ".join(out), flush=True)
        del o, w
    return 0


if __name__ == "__main__":
    sys.exit(main())
