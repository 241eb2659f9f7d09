"""The arithmetic of the CUDA rwkv6_scan_bwd kernel, modelled on the CPU.

``csrc/rwkv6_scan_bwd.cu`` runs the wkv scan's reverse pass in closed
chunk form on TF32 tensor cores.  A card is needed to run it; its
arithmetic is not.  ``bwd_model`` below repeats it in numpy, tile for tile:
tiles of ``STAGE_STEPS`` steps walked last first, each two sub-chunks of
``SUB_CHUNK`` with their own midpoints and a cross block between them,
each step's log-decay floored at ``LOGW_FLOOR``, exponentials in base 2,
masked score entries discarded by select, a tile's start state taken from
its checkpoint (and replayed step by step past a chunk's first tile), the
key channels cut into ``bwd_splits(D)`` blocks whose dv partials add up,
and every product on TF32 operands split three ways.  dlogw comes from
per-tile sums of exact terms, with no per-step state:

  dlogw_t = rho_t (Ac c0 + sum_{s<t} Kin_s VG_s + sum_{tau>t} Rs_tau HS_tau
                   + sum_{s<t<tau} Z[tau, s]),

rho_t = exp(logw_t) / exp(max(logw_t, floor)) (so dlogw is the unfloored
function's, as the plain version's), Ac c0 = exp(la_end) sum_j dS_end (.) S0
and Z[tau, s] = r_tau k_s (dy_tau . v_s) exp(la_prev_tau - la_s).

It is held at SCAN_TOL (1e-4 of each output's max, as ``chip_smoke.py``
holds the card) against the port's plain reverse scan
(``kernels/ref.rwkv6_scan_bwd``) and against ``jax.vjp`` of the
reference's ``_wkv_scan``.  It also shows why the kernel takes dlogw from
those exact terms and not from a reverse cumulative sum of
dL/d(cumsum logw) (r dr - k dk per step): at strong decay the query and key
parts cancel far below their size and the sum misses the tolerance.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (LOGW_FLOOR, STAGE_STEPS,  # noqa: E402
                                            SUB_CHUNK, bwd_splits)
from test_torch_rwkv6_chunk import _inputs, _rna, _trunc  # noqa: E402

torch.set_num_threads(2)
SCAN_TOL = 1e-4          # chip_smoke.py: of each output's max |value|
LOG2E = np.float32(1.4426950408889634)
F32 = np.float32
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
        / "csrc" / "rwkv6_scan_bwd.cu")
T, C = STAGE_STEPS, SUB_CHUNK


def _t(x):
    return np.swapaxes(x, -1, -2)


def _mm(a, b, three: bool):
    """a @ b on TF32 operands with fp32 sums: split three ways (hi rounded
    to TF32, lo = a - hi truncated; lo·hi + hi·lo + hi·hi), or plain.  The
    products go through torch, whose CPU threads the test modules bound."""
    def mm(x, y):
        return (torch.from_numpy(np.ascontiguousarray(x))
                @ torch.from_numpy(np.ascontiguousarray(y))).numpy()

    with np.errstate(all="ignore"):
        if not three:
            return mm(_trunc(a), _trunc(b))
        ah, bh = _rna(a), _rna(b)
        al, bl = _trunc(a - ah), _trunc(b - bh)
        return mm(al, bh) + mm(ah, bl) + mm(ah, bh)


def _shift(lam):
    """The exclusive cumsum of a sub-chunk (the kernel's la before its
    step's decay is added): 0, lam[0], ..., lam[C - 2]."""
    out = np.zeros_like(lam)
    out[..., 1:, :] = lam[..., :-1, :]
    return out


def bwd_model(r, k, v, logw, u, ckpt, dy, dstate, *, chunk, three=True,
              dlogw_form="exact"):
    """The kernel's arithmetic.  r/k/v/logw/dy: (B, S, H, D) float32 numpy
    (bf16 inputs already rounded); u: (H, D); ckpt (B, H, ceil(S / chunk),
    D, D); dstate (B, H, D, D) or None.  Returns (dr, dk, dv, dlogw (B, S,
    H, D), du (H, D)).  ``dlogw_form="cumsum"`` takes dlogw from the
    reverse cumulative sum of dL/d(la) instead (the form the kernel does
    not use)."""
    b, s, h, d = r.shape
    n = -(-s // T) * T

    def heads_first(x):                  # (B, H, n, D), zero past S
        out = np.zeros((b, h, n, d), F32)
        out[:, :, :s] = x.transpose(0, 2, 1, 3)
        return out

    r, k, v, logw, dy = (heads_first(x) for x in (r, k, v, logw, dy))
    u = u.astype(F32)[None, :, None, :]                       # (1, H, 1, D)
    g = (np.zeros((b, h, d, d), F32) if dstate is None
         else dstate.astype(F32).copy())
    dr, dk, dv, dlw = (np.zeros((b, h, n, d), F32) for _ in range(4))
    du = np.zeros((b, h, d), F32)
    tpc = chunk // T
    split = bwd_splits(d)
    di = d // split
    ti = np.arange(T)[:, None]
    si = np.arange(T)[None, :]
    low = si < ti                                             # [t, s]: s < t
    # [tau, s, t]: s < t < tau, the pairs of Z that reach step t
    between = ((np.arange(T)[None, :, None] < np.arange(T)[None, None, :])
               & (np.arange(T)[None, None, :] < np.arange(T)[:, None, None]))
    mm = lambda a, c: _mm(a, c, three)                        # noqa: E731
    with np.errstate(all="ignore"):
        for x in reversed(range(n // T)):
            cidx, _ = divmod(x, tpc)
            s0 = ckpt[:, :, cidx].astype(F32).copy()
            for p in range(cidx * tpc * T, x * T):            # replay
                w = np.exp(np.maximum(logw[:, :, p], F32(LOGW_FLOOR))).astype(F32)
                s0 = w[..., None] * s0 + k[:, :, p, :, None] * v[:, :, p, None, :]
            tile = slice(x * T, (x + 1) * T)
            rc, kc, vc, lwc, dyc = (a[:, :, tile] for a in (r, k, v, logw, dy))
            l2 = np.maximum(lwc, F32(LOGW_FLOOR)) * LOG2E
            lam = np.concatenate([np.cumsum(l2[:, :, :C], axis=2, dtype=F32),
                                  np.cumsum(l2[:, :, C:], axis=2, dtype=F32)],
                                 axis=2)
            lamp = np.concatenate([_shift(lam[:, :, :C]), _shift(lam[:, :, C:])],
                                  axis=2)
            sum0, sum1 = lam[:, :, C - 1:C], lam[:, :, T - 1:T]   # (B, H, 1, D)
            ref0, ref1 = F32(0.5) * sum0, F32(0.5) * sum1
            refh = np.concatenate([np.repeat(ref0, C, 2), np.repeat(ref1, C, 2)], 2)
            r0, r1, k0, k1 = rc[:, :, :C], rc[:, :, C:], kc[:, :, :C], kc[:, :, C:]
            rt = rc * np.exp2(lamp - refh)                    # R~, both halves
            kt = kc * np.exp2(refh - lam)                     # K~
            ksub0 = k0 * np.exp2(sum0 - lam[:, :, :C])
            rsub1 = r1 * np.exp2(lamp[:, :, C:])
            rx = np.concatenate([rt[:, :, :C], rsub1 * np.exp2(ref0), rt[:, :, C:]], 2)
            kx = np.concatenate([kt[:, :, :C], ksub0 * np.exp2(ref1), kt[:, :, C:]], 2)
            fp = np.concatenate([np.exp2(lamp[:, :, :C]),
                                 np.exp2(sum0 + lamp[:, :, C:])], 2)
            fe = np.concatenate([np.exp2((sum0 - lam[:, :, :C]) + sum1),
                                 np.exp2(sum1 - lam[:, :, C:])], 2)
            rs, kin = rc * fp, kc * fe
            ac = np.exp2(sum0 + sum1)[:, :, 0]                # (B, H, D)
            fr, fk = np.exp2(lamp - refh), np.exp2(refh - lam)

            hs = mm(dyc, _t(s0))                              # dY S0^T
            vg = mm(vc, _t(g))                                # V G^T
            m = mm(dyc, _t(vc))                               # [t, s] = dy_t . v_s
            dyv = np.diagonal(m, axis1=2, axis2=3)            # (B, H, T)
            mlow = np.where(low, m, F32(0))
            # dR's intra part: [t, kk] against Kx's 24 rows
            mx = np.zeros((b, h, T, 3 * C), F32)
            mx[:, :, :C, :C] = mlow[:, :, :C, :C]
            mx[:, :, C:, C:2 * C] = mlow[:, :, C:, :C]
            mx[:, :, C:, 2 * C:] = mlow[:, :, C:, C:]
            # dK's: [s, kk] against Rx's 24 rows (kk = tau, tau, tau + 8)
            mxt = np.zeros((b, h, T, 3 * C), F32)
            mxt[:, :, :C, :C] = _t(mlow[:, :, :C, :C])
            mxt[:, :, :C, C:2 * C] = _t(mlow[:, :, C:, :C])
            mxt[:, :, C:, 2 * C:] = _t(mlow[:, :, C:, C:])
            dri, dki = mm(mx, kx), mm(mxt, rx)
            drt = fp * hs + fr * dri + (u * kc) * dyv[..., None]
            dkt = fe * vg + fk * dki + (u * rc) * dyv[..., None]

            c0 = np.sum(g * s0, axis=-1, dtype=F32)           # (B, H, D)
            dvt = np.zeros((b, h, T, d), F32)
            for blk in range(split):                          # key-channel blocks
                ii = slice(blk * di, (blk + 1) * di)
                sc = np.zeros((b, h, T, T), F32)
                sc[:, :, :C, :C] = mm(rx[:, :, :C, ii], _t(kx[:, :, :C, ii]))
                sc[:, :, C:, C:] = mm(rx[:, :, 2 * C:, ii], _t(kx[:, :, 2 * C:, ii]))
                sc[:, :, C:, :C] = mm(rsub1[..., ii], _t(ksub0[..., ii]))
                sc = np.where(low, sc, F32(0))
                # sum_i r u k on A's diagonal: dv's bonus rides its product
                ruk = np.sum(rc[..., ii] * u[..., ii] * kc[..., ii], -1, dtype=F32)
                sc = sc + ruk[..., None] * np.eye(T, dtype=F32)
                dvt = dvt + (mm(kin[..., ii], g[:, :, ii]) + mm(_t(sc), dyc))
            g_new = ac[..., None] * g + mm(_t(rs), dyc)

            if dlogw_form == "exact":
                # Z[tau, s] per channel: each block's own pair of factors
                zf = np.zeros((b, h, T, T, d), F32)
                zf[:, :, :C, :C] = rt[:, :, :C, None] * kt[:, :, None, :C]
                zf[:, :, C:, C:] = rt[:, :, C:, None] * kt[:, :, None, C:]
                zf[:, :, C:, :C] = rsub1[:, :, :, None] * ksub0[:, :, None]
                z = mlow[..., None] * np.where(low[..., None], zf, F32(0))
                pre = np.zeros_like(vg)               # sums before, never
                suf = np.zeros_like(hs)               # a difference of two
                pre[:, :, 1:] = np.cumsum((kin * vg)[:, :, :-1], axis=2, dtype=F32)
                suf[:, :, :-1] = np.cumsum((rs * hs)[:, :, :0:-1], axis=2,
                                           dtype=F32)[:, :, ::-1]
                zsum = np.einsum("bhqsi,qst->bhti", z, between.astype(F32))
                rho = np.exp2(np.minimum(lwc - F32(LOGW_FLOOR), F32(0)) * LOG2E)
                dlt = rho * (ac[:, :, None] * c0[:, :, None] + pre + suf + zsum)
            else:
                # dL/dla_tau: r_{tau+1} dr_{tau+1} - k_tau dk_tau (bonus-free),
                # and sum_j dS_end S_end at the tile's last step
                drs = drt - (u * kc) * dyv[..., None]
                dks = dkt - (u * rc) * dyv[..., None]
                s_end = ac[..., None] * s0 + mm(_t(kin), vc)
                gla = -kc * dks
                gla[:, :, :-1] += rc[:, :, 1:] * drs[:, :, 1:]
                gla[:, :, -1] += np.sum(g * s_end, axis=-1, dtype=F32)
                dlt = np.cumsum(gla[:, :, ::-1], axis=2, dtype=F32)[:, :, ::-1]

            dr[:, :, tile], dk[:, :, tile], dv[:, :, tile] = drt, dkt, dvt
            dlw[:, :, tile] = dlt
            du += np.sum(rc * kc * dyv[..., None], axis=2, dtype=F32)
            g = g_new.astype(F32)

    def back(a):
        return a[:, :, :s].transpose(0, 2, 1, 3)

    return back(dr), back(dk), back(dv), back(dlw), du.sum(0, dtype=F32)


def _case(b, s, h, d, decay, seed, dtype="float32", chunk=16, with_dstate=False):
    """Inputs, the plain forward's checkpoints, dy and dstate, as numpy."""
    r, k, v, logw, u = _inputs(b, s, h, d, decay, seed, dtype)
    rng = np.random.default_rng(seed + 1)
    dy = rng.standard_normal((b, s, h, d)).astype(F32)
    ds = (rng.standard_normal((b, h, d, d)).astype(F32) if with_dstate else None)
    _, _, ck = ref.rwkv6_scan(*(torch.from_numpy(x) for x in (r, k, v, logw, u)),
                              chunk=chunk)
    return r, k, v, logw, u, ck.numpy(), dy, ds


def _plain(r, k, v, logw, u, ck, dy, ds, chunk):
    t = [torch.from_numpy(x) for x in (r, k, v, logw, u, ck, dy)]
    got = ref.rwkv6_scan_bwd(*t, None if ds is None else torch.from_numpy(ds),
                             chunk=chunk)
    return [x.numpy() for x in got]


def _misses(got, want):
    """Names of the outputs outside SCAN_TOL of their own max |value|."""
    names = ("dr", "dk", "dv", "dlogw", "du")
    bad = []
    for name, g_, w_ in zip(names, got, want):
        w_ = np.asarray(w_, np.float64)
        atol = SCAN_TOL * float(np.abs(w_).max(initial=0.0))
        if not (np.isfinite(g_).all() and np.all(np.abs(g_ - w_) <= atol)):
            bad.append((name, float(np.abs(g_ - w_).max()), atol))
    return bad


@pytest.mark.parametrize("decay", ["mild", -8.0, -20.0, "mixed"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("s", [1, 16, 17, 37, 130])
def test_bwd_model_matches_the_plain_reverse_scan(s, d, decay):
    """Ragged and whole tiles, S past several chunks, every head dim, mild
    to extreme decay (logw -20, and 0 beside -20 channel by channel), with
    and without dstate, checkpoints every 16 and 32 steps (a chunk's second
    tile replayed from its checkpoint): each gradient within SCAN_TOL of the
    plain fp32 reverse scan's."""
    for chunk, with_ds in ((16, False), (16, True), (32, True), (32, False)):
        args = _case(2, s, 2, d, decay, seed=s * 131 + d + chunk, chunk=chunk,
                     with_dstate=with_ds)
        got = bwd_model(*args, chunk=chunk)
        assert not _misses(got, _plain(*args, chunk)), (chunk, with_ds)


@pytest.mark.parametrize("decay", ["mild", "mixed"])
@pytest.mark.parametrize("s,d", [(17, 16), (37, 64), (40, 128)])
def test_bwd_model_bf16_inputs(s, d, decay):
    """r/k/v rounded to bf16 (exact in TF32, as the kernel reads them)."""
    args = _case(2, s, 2, d, decay, seed=5 * s + d, dtype="bfloat16",
                 with_dstate=True)
    assert not _misses(bwd_model(*args, chunk=16), _plain(*args, 16))


@pytest.mark.parametrize("decay", ["mild", -8.0, -20.0, "mixed"])
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("s", [1, 37, 130])
def test_bwd_model_matches_jax_vjp(s, d, decay):
    """Against ``jax.vjp`` of the reference's ``_wkv_scan`` (its training
    path, chunks of 128 under ``jax.checkpoint``; dlogw = dw · w), with
    cotangents on y and on the final state together."""
    r, k, v, logw, u, ck, dy, ds = _case(1, s, 2, d, decay, seed=s + 7 * d,
                                         with_dstate=True)
    w = np.exp(logw)
    state0 = jnp.zeros((1, 2, d, d), jnp.float32)
    _, vjp = jax.vjp(lambda *a: jrwkv._wkv_scan(*a, state0, return_states=False),
                     *(jnp.asarray(x) for x in (r, k, v, w, u)))
    jdr, jdk, jdv, jdw, jdu = vjp((jnp.asarray(dy), jnp.asarray(ds)[:, None]))
    want = (jdr, jdk, jdv, np.asarray(jdw) * w, jdu)
    got = bwd_model(r, k, v, logw, u, ck, dy, ds, chunk=16)
    assert not _misses(got, want)


@pytest.mark.parametrize("decay", [-8.0, -20.0])
def test_cumsum_dlogw_cancels_past_the_tolerance(decay):
    """Why dlogw is taken from exact terms: as a reverse cumulative sum of
    dL/d(la) = r_{t+1} dr_{t+1} - k_t dk_t, the parts cancel down to w_t
    times their size, and at strong decay fp32 keeps too few of the
    surviving digits.  The exact form meets SCAN_TOL on the same inputs;
    the other gradients are the same in both."""
    args = _case(2, 64, 2, 64, decay, seed=11)
    want = _plain(*args, 16)
    exact = bwd_model(*args, chunk=16)
    cums = bwd_model(*args, chunk=16, dlogw_form="cumsum")
    assert not _misses(exact, want)
    assert [m[0] for m in _misses(cums, want)] == ["dlogw"]


@pytest.mark.parametrize("decay", ["mild", -8.0])
def test_plain_tf32_misses_the_tolerance(decay):
    """Why the products are split three ways: with one TF32 product each
    the reverse scan misses SCAN_TOL; split, it meets it."""
    args = _case(2, 64, 2, 64, decay, seed=3)
    want = _plain(*args, 16)
    assert _misses(bwd_model(*args, chunk=16, three=False), want)
    assert not _misses(bwd_model(*args, chunk=16), want)


def test_splits_are_the_kernels():
    """The model's key-channel blocks are the kernel's: two blocks per
    (batch row, head) at D 128, one below."""
    assert [bwd_splits(d) for d in (16, 32, 64, 128)] == [1, 1, 1, 2]


def test_constants_are_the_kernels():
    """The Python twins of the kernel's sub-chunk, tile, floor and split,
    which this model uses, are the constants the CUDA source compiles."""
    src = CSRC.read_text()
    assert re.search(rf"constexpr int kSub = {SUB_CHUNK};", src)
    assert re.search(r"constexpr int kTile = 2 \* kSub;", src)
    assert STAGE_STEPS == 2 * SUB_CHUNK
    assert re.search(rf"constexpr float kLogwFloor = {LOGW_FLOOR:.0f}\.f;", src)
    assert re.search(r"kSplit = D >= 128 \? 2 : 1;", src)
