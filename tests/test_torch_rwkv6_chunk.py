"""The arithmetic of the CUDA rwkv6_scan kernel, modelled on the CPU.

``csrc/rwkv6_scan.cu`` runs the wkv recurrence in its closed chunk form on
TF32 tensor cores.  A card is needed to run it; its arithmetic is not.
``chunk_model`` below repeats it in numpy, step for step: tiles of
``STAGE_STEPS`` steps, each two sub-chunks of ``SUB_CHUNK`` with their own
midpoint renormalisation and a cross block between them, each step's
log-decay floored at ``LOGW_FLOOR``, exponentials in base 2, masked score
entries discarded by select (they may be inf or NaN), and every product on
TF32 operands split three ways (hi rounded to TF32, lo = x - hi truncated
to TF32 as the mma reads it; hi·hi + hi·lo + lo·hi in fp32).  It is held
against the port's plain recurrence (``kernels/ref.rwkv6_scan``) and the
reference's Pallas kernel in interpret mode at ``chip_smoke.py``'s
SCAN_TOL, and it shows why the kernel differs from the reference's
algebra: the reference's 16-step chunk with one midpoint is wrong at
logw -20, and plain TF32 products miss SCAN_TOL.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (LOGW_FLOOR, STAGE_STEPS,  # noqa: E402
                                            SUB_CHUNK)

SCAN_TOL = 1e-4          # chip_smoke.py: relative, and of max|out| absolute
LOG2E = np.float32(1.4426950408889634)
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
        / "csrc" / "rwkv6_scan.cu")


def _trunc(x):
    """TF32 as the mma reads an fp32 register: the low 13 mantissa bits
    cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _rna(x):
    """hi as the kernel rounds it, (bits + 0x1000) & ~0x1fff: to the nearest
    TF32, ties away from zero (cvt.rna's rounding)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm(a, b, three: bool):
    """a @ b on TF32 operands with fp32 sums: split three ways, or plain."""
    with np.errstate(all="ignore"):
        if not three:
            return _trunc(a) @ _trunc(b)
        ah, bh = _rna(a), _rna(b)
        al, bl = _trunc(a - ah), _trunc(b - bh)
        return al @ bh + ah @ bl + ah @ bh


def chunk_model(r, k, v, logw, u, *, three: bool = True):
    """The kernel's arithmetic.  r/k/v/logw: (B, S, H, D) float32 numpy
    (bf16 inputs already rounded); u: (H, D).  Returns (y (B, S, H, D),
    final state (B, H, D, D))."""
    b, s, h, d = r.shape
    n = -(-s // STAGE_STEPS) * STAGE_STEPS

    def heads_first(t):                  # (B, H, n, D), zero past S
        out = np.zeros((b, h, n, d), np.float32)
        out[:, :, :s] = t.transpose(0, 2, 1, 3)
        return out

    r, k, v, logw = (heads_first(t) for t in (r, k, v, logw))
    state = np.zeros((b, h, d, d), np.float32)
    y = np.zeros((b, h, n, d), np.float32)
    ti = np.arange(STAGE_STEPS)[:, None]
    si = np.arange(STAGE_STEPS)[None, :]
    c = SUB_CHUNK
    with np.errstate(all="ignore"):
        for t0 in range(0, n, STAGE_STEPS):
            tile = slice(t0, t0 + STAGE_STEPS)
            rc, kc, vc = r[:, :, tile], k[:, :, tile], v[:, :, tile]
            l2 = np.maximum(logw[:, :, tile], np.float32(LOGW_FLOOR)) * LOG2E
            subs = []                    # per sub-chunk: R~, K~, rs, ks, sum
            for half in (0, 1):
                sub = slice(half * c, (half + 1) * c)
                la = np.cumsum(l2[:, :, sub], axis=2, dtype=np.float32)
                la_prev = la - l2[:, :, sub]
                mid = np.float32(0.5) * la[:, :, -1:]
                er = np.exp2(mid)
                rt = rc[:, :, sub] * np.exp2(la_prev - mid)
                kt = kc[:, :, sub] * np.exp2(mid - la)
                subs.append((rt, kt, rt * er, kt * er, la[:, :, -1:]))
            (rt0, kt0, rs0, ks0, sum0), (rt1, kt1, rs1, ks1, sum1) = subs
            # tile-level decays: r after sub-chunk 0's steps, k before 1's
            rs = np.concatenate([rs0, rs1 * np.exp2(sum0)], axis=2)
            kin = np.concatenate([ks0 * np.exp2(sum1), ks1], axis=2)
            ac = np.exp2(sum0 + sum1)
            scores = np.zeros((b, h, STAGE_STEPS, STAGE_STEPS), np.float32)
            scores[:, :, :c, :c] = _mm(rt0, kt0.transpose(0, 1, 3, 2), three)
            scores[:, :, c:, c:] = _mm(rt1, kt1.transpose(0, 1, 3, 2), three)
            scores[:, :, c:, :c] = _mm(rs1, ks0.transpose(0, 1, 3, 2), three)
            diag = np.sum(rc * u[None, :, None, :] * kc, axis=-1,
                          dtype=np.float32)
            a = np.where(si < ti, scores,
                         np.where(si == ti, diag[..., None], np.float32(0.0)))
            y[:, :, tile] = _mm(rs, state, three) + _mm(a, vc, three)
            state = (ac[:, :, 0, :, None] * state
                     + _mm(kin.transpose(0, 1, 3, 2), vc, three))
    return y[:, :, :s].transpose(0, 2, 1, 3), state


def _inputs(b, s, h, d, decay, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    if dtype == "bfloat16":
        r, k, v = (torch.from_numpy(t).bfloat16().float().numpy()
                   for t in (r, k, v))
    if decay == "mild":
        logw = -np.exp(rng.standard_normal((b, s, h, d)) * 0.5 - 1.0)
    elif decay == "mixed":            # channels without decay beside e^-20
        logw = np.zeros((b, s, h, d))
        logw[..., 1::2] = -20.0
    else:
        logw = np.full((b, s, h, d), decay)
    u = rng.standard_normal((h, d)) * 0.1
    return r, k, v, logw.astype(np.float32), u.astype(np.float32)


def _within(got, want) -> bool:
    want = np.asarray(want, np.float32)
    return bool(np.isfinite(got).all()) and np.allclose(
        got, want, rtol=SCAN_TOL, atol=SCAN_TOL * float(np.abs(want).max()))


def _plain(r, k, v, logw, u):
    y, st = ref.rwkv6_scan(*(torch.from_numpy(t) for t in (r, k, v, logw, u)))
    return y.numpy(), st.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", ["mild", -8.0, -20.0, "mixed"])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 37, 64])
def test_chunk_model_matches_the_recurrence(s, decay, dtype):
    """Every head dim, ragged and whole sub-chunks and tiles, mild to
    extreme decay: y and the final state within SCAN_TOL of the plain
    fp32 recurrence."""
    for d in (16, 32, 64, 128):
        args = _inputs(2, s, 2, d, decay, seed=s * 131 + d, dtype=dtype)
        got, want = chunk_model(*args), _plain(*args)
        for g, w, name in zip(got, want, ("y", "state")):
            assert _within(g, w), (name, d, np.abs(g - w).max())


@pytest.mark.parametrize("decay", ["mild", -8.0])
@pytest.mark.parametrize("s,d", [(16, 16), (37, 64)])
def test_chunk_model_matches_the_pallas_kernel(s, d, decay):
    """Where the reference's own chunk algebra holds, the model agrees with
    its Pallas kernel (interpret mode) within SCAN_TOL."""
    args = _inputs(1, s, 2, d, decay, seed=7 * s + d)
    py, ps = jops.rwkv6_scan(*(jnp.asarray(t) for t in args), chunk=16,
                             interpret=True)
    got = chunk_model(*args)
    assert _within(got[0], py) and _within(got[1], ps)


def test_reference_chunk_fails_at_logw_minus_20_and_the_model_does_not():
    """At logw -20 a 16-step chunk decays by e^-320 per channel: one
    midpoint cannot keep both factors of a neighbour pair inside fp32, and
    the reference's kernel loses the pair's weight of 1.  The kernel's
    8-step sub-chunks and floored log-decay keep it."""
    args = _inputs(1, 48, 2, 16, -20.0, seed=0)
    want = _plain(*args)
    py, _ = jops.rwkv6_scan(*(jnp.asarray(t) for t in args), chunk=16,
                            interpret=True)
    assert not _within(np.asarray(py), want[0])
    assert _within(chunk_model(*args)[0], want[0])


@pytest.mark.parametrize("decay", ["mild", -8.0])
def test_plain_tf32_misses_the_tolerance(decay):
    """Why the products are split three ways: with one TF32 product each
    (10-bit mantissas) the scan misses SCAN_TOL; split, it meets it."""
    args = _inputs(2, 64, 2, 64, decay, seed=3)
    want = _plain(*args)
    assert not _within(chunk_model(*args, three=False)[0], want[0])
    assert _within(chunk_model(*args)[0], want[0])


def test_bf16_v_needs_no_low_part():
    """A bf16 v is exact in TF32 (8-bit mantissa), so the kernel's products
    with v take two terms: its low part is zero."""
    v = torch.randn(4096).bfloat16().float().numpy()
    assert np.array_equal(_rna(v), v)
    assert not np.any(_trunc(v - _rna(v)))


def test_constants_are_the_kernels():
    """The Python twins of the kernel's sub-chunk, tile and floor, which
    this model uses, are the constants the CUDA source compiles."""
    src = CSRC.read_text()
    assert re.search(rf"constexpr int kSub = {SUB_CHUNK};", src)
    assert re.search(r"constexpr int kTile = 2 \* kSub;", src)
    assert STAGE_STEPS == 2 * SUB_CHUNK
    assert re.search(rf"constexpr float kLogwFloor = {LOGW_FLOOR:.0f}\.f;", src)
