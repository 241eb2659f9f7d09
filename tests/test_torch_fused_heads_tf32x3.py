"""The arithmetic of the fused-heads kernel's fp32 body, modelled on the CPU.

``csrc/fused_heads.cu`` computes fp32 logits on the TF32 tensor cores:
each operand is split as hi = rna(x), lo = rna(x - hi) (rounded to the
nearest TF32, ties away from zero, by bit operations), and every 8-deep
step of d adds W_lo·o_hi, then W_hi·o_lo, then W_hi·o_hi into an fp32
partial sum ("3xTF32"), which every PROMOTE_D of d is added into the
tile's fp32 logits.  A card is needed to run the kernel; its arithmetic is
not.  ``tf32x3_logits`` repeats it in torch: products of TF32 values are
exact in fp32, the sums are fp32.  At the path's deepest
reductions (d 4096, nemotron's 6144, llava's 7168; 56 rows, 2048 lanes) it
is held against the reference's Pallas kernel in interpret mode (ids
equal, values within 2e-5) and against float64 logits (within 2e-5 of
max|logit|); a single TF32 product misses that, which is why the kernel
splits.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_heads import fused_heads_topk_pallas  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = 2e-5               # chip_smoke.py: ATTN_TOL["float32"]
PROMOTE_D = 32           # d per partial sum: one fp32 stage
ROWS, LANES = 56, 2048
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
        / "csrc" / "fused_heads.cu")


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 (ties away from zero) as an fp32 tensor:
    add half a TF32 ulp to the magnitude bits, clear the low 13."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32x3_logits(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, d) x (d, V) in fp32 as the kernel sums it: per 8-deep step,
    lo·hi, hi·lo, hi·hi, each added to a partial sum that each PROMOTE_D
    of d adds into the logits."""
    o_hi, o_lo = split(o)
    w_hi, w_lo = split(w)
    acc = torch.zeros((o.shape[0], w.shape[1]), dtype=torch.float32)
    for p in range(0, o.shape[1], PROMOTE_D):
        part = torch.zeros_like(acc)
        for k in range(p, min(p + PROMOTE_D, o.shape[1]), 8):
            s = slice(k, k + 8)
            part += o_hi[:, s] @ w_lo[s]
            part += o_lo[:, s] @ w_hi[s]
            part += o_hi[:, s] @ w_hi[s]
        acc += part
    return acc


def _case(d: int):
    rng = np.random.default_rng(d)
    o = rng.standard_normal((ROWS, d)).astype(np.float32)
    w = (rng.standard_normal((d, LANES)) * 0.02).astype(np.float32)
    return o, w


_LOGITS = {}


def _emulated(d: int) -> torch.Tensor:
    if d not in _LOGITS:
        o, w = _case(d)
        _LOGITS[d] = tf32x3_logits(torch.from_numpy(o), torch.from_numpy(w))
    return _LOGITS[d]


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                   # TF32's 10 mantissa bits, at 1.0
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 4, 1.0 + 3 * ulp / 4,
                      -(1.0 + ulp / 2), 3.0e-39, 0.0], dtype=torch.float32)
    want = [1.0, 1.0 + ulp, 1.0, 1.0 + ulp, -(1.0 + ulp)]
    got = tf32_rna(x)
    assert got[:5].tolist() == want
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    hi, lo = split(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).eq(0).all()


def test_the_kernel_rounds_and_sums_as_modelled():
    """The model's constants and product order are the kernel's."""
    src = CSRC.read_text()
    body = re.search(r"uint32_t tf32_rna\(float x\) \{\s*return (.*?);", src)
    assert body and body.group(1) == \
        "(__float_as_uint(x) + 0x1000u) & 0xffffe000u"
    assert "lo[j] = tf32_rna(x - __uint_as_float(hi[j]));" in src
    products = re.findall(
        r"wgmma_m64n64k8_tf32\(part\[0\], (\w+), (\w+), ([^)]+)\)", src)
    # a fresh partial sum at each stage's first step (scale-d 0), then added
    assert products == [("lo", "b_hi", "kc > 0"), ("hi", "b_lo", "1"),
                        ("hi", "b_hi", "1")]
    assert re.search(r"for \(int kc = 0; kc < kDepth / 8; \+\+kc\)", src)
    assert "acc[0][i] += part[0][i];" in src
    assert "kDepth = 128 / int(sizeof(T));" in src       # 32 of d in fp32


@pytest.mark.parametrize("top_t", [1, 8])
@pytest.mark.parametrize("d", [4096, 6144, 7168])
def test_tf32x3_matches_the_pallas_kernel(d, top_t):
    o, w = _case(d)
    vals, ids = ref.top_t_ids(_emulated(d), top_t)
    want_v, want_i = fused_heads_topk_pallas(jnp.asarray(o), jnp.asarray(w),
                                             vocab=LANES, top_t=top_t,
                                             interpret=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_v), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("d", [4096, 6144, 7168])
def test_tf32x3_within_fp64(d):
    o, w = _case(d)
    exact = o.astype(np.float64) @ w.astype(np.float64)
    err = np.abs(_emulated(d).numpy() - exact).max()
    assert err <= TOL * np.abs(exact).max(), (err, np.abs(exact).max())


def test_one_tf32_product_misses_the_tolerance():
    """hi·hi alone (TF32 as the tensor cores would take fp32) is about
    1e-4 of max|logit| off at d 4096: the split is needed."""
    o, w = _case(4096)
    exact = o.astype(np.float64) @ w.astype(np.float64)
    one = (tf32_rna(torch.from_numpy(o)) @ tf32_rna(torch.from_numpy(w))).numpy()
    assert np.abs(one - exact).max() > 4 * TOL * np.abs(exact).max()
