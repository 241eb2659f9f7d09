"""Plain PyTorch versions of the CUDA kernels (twins of ``repro.kernels.ref``).

Self-contained (no imports from ``repro_torch.models``) so a kernel test
failure implicates the kernel, not the model stack.  These serve CPU tensors
in ``kernels.ops`` and are what the tests and ``chip_smoke.py`` hold the
kernels against.  Ties go to the lowest token id, as ``jnp.argmax`` and
``lax.top_k`` give: ``torch.argmax`` returns the first maximum, and top-T>1
uses a stable descending sort (``torch.topk`` promises no order among ties).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
CRITERIA = ("exact", "topk", "distance")


def top_t_ids(x: torch.Tensor, t: int):
    """Top-``t`` (values, ids) along the last dim, ordered by (value desc,
    id asc)."""
    if t == 1:
        ids = torch.argmax(x, dim=-1, keepdim=True)
    else:
        ids = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :t]
    return torch.gather(x, -1, ids), ids


# ---------------------------------------------------------------------------
# block_attention
# ---------------------------------------------------------------------------


def verify_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                     num_meta: int = 0) -> torch.Tensor:
    """q: (B, kq, H, hd); k/v: (B, L, KV, hd); q_pos (B, kq); kv_pos (B, L).

    Head h = kv·G + g; masked scores are the finite -1e30, so a row with no
    visible entry averages V instead of producing NaN.  Returns (B, kq, H,
    hd) in q's dtype.
    """
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    mask = (kp >= 0) & (kp <= qp)
    if window:
        mask &= (qp - kp < window) | (kp < num_meta)
    return _masked_attend(q, k, v, mask)


def _masked_attend(q, k, v, mask) -> torch.Tensor:
    """fp32 GQA attention of q (B, kq, H, hd) over k/v (B, L, KV, hd) under
    mask (B, kq, L); head h = kv·G + g.  Masked scores are -1e30."""
    b, kq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, kq, kvh, h // kvh, hd).float()
    scores = torch.einsum("bqhgk,bshk->bhgqs", qg, k.float())
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhgqs,bshk->bqhgk", probs, v.float())
    return ctx.reshape(b, kq, h, hd).to(q.dtype)


def tree_verify_attention(q, k, v, q_pos, kv_pos, kv_node, anc_bits, *,
                          window: int = 0, num_meta: int = 0) -> torch.Tensor:
    """``verify_attention`` for a candidate tree.  kv_node: (B, L) node index
    of this block's tree slots, -1 for committed-prefix slots; anc_bits:
    (B, kq) int32 packed ancestor-or-self bitmask per query node (bit 31 may
    be set).  Positions are logical (RoPE) positions.  A tree slot is
    visible only if the query's bit for its node is set; ``>>`` on int32 is
    arithmetic, and ``& 1`` keeps bit n alone, as the reference's logical
    shift does."""
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    kn = kv_node[:, None, :]
    mask = (kp >= 0) & (kp <= qp)
    if window:
        mask &= (qp - kp < window) | (kp < num_meta)
    bit = (anc_bits.to(torch.int32)[:, :, None] >> kn.clamp(0, 31)) & 1
    mask &= (kn < 0) | (bit != 0)
    return _masked_attend(q, k, v, mask)


def paged_verify_attention(q, kp, vp, tbl, q_pos, kv_pos, *, window: int = 0,
                           num_meta: int = 0) -> torch.Tensor:
    """q: (B, kq, H, hd); kp/vp: (num_pages, ps, KV, hd); tbl: (B, P) int32;
    kv_pos: (B, P·ps).  Gathers the pages densely (``kp[tbl]``), then the
    dense plain version."""
    b, P = tbl.shape
    _, ps, kvh, hd = kp.shape
    idx = tbl.long()
    k = kp[idx].reshape(b, P * ps, kvh, hd)
    v = vp[idx].reshape(b, P * ps, kvh, hd)
    return verify_attention(q, k, v, q_pos, kv_pos, window=window,
                            num_meta=num_meta)


# ---------------------------------------------------------------------------
# rwkv6_scan (sequential recurrence, f32)
# ---------------------------------------------------------------------------


def rwkv6_scan(r, k, v, logw, u, *, chunk: int = 0):
    """r/k/v/logw: (B, S, H, D); u: (H, D).  Zero initial state;
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t, y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)
    with w = exp(logw).  Returns (y (B, S, H, D) f32, final state (B, H, D,
    D) f32); with ``chunk`` > 0 also the state at the start of every chunk
    of that many steps, (B, H, ⌈S / chunk⌉, D, D) f32 (the first zero): the
    checkpoints ``rwkv6_scan_bwd`` recomputes each chunk's states from."""
    b, s, h, d = r.shape
    rf, kf, vf = (t.float() for t in (r, k, v))
    wf = torch.exp(logw.float())
    uf = u.float()[None, :, :, None]
    state = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    ys, checkpoints = [], []
    for t in range(s):
        if chunk and t % chunk == 0:
            checkpoints.append(state)
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]          # (B, H, D, D)
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], state + uf * kv))
        state = wf[:, t, :, :, None] * state + kv
    if chunk:
        return torch.stack(ys, dim=1), state, torch.stack(checkpoints, dim=2)
    return torch.stack(ys, dim=1), state


def rwkv6_scan_bwd(r, k, v, logw, u, checkpoints, dy, dstate, *, chunk: int):
    """The gradient of ``rwkv6_scan`` by the sequential fp32 reverse scan.

    ``checkpoints`` (B, H, ⌈S / chunk⌉, D, D) are the forward's states at
    the chunk starts; ``dy`` (B, S, H, D) and ``dstate`` (B, H, D, D, or
    None for zeros) the cotangents of y and of the final state.  Each chunk,
    last first, recomputes its states S_{t-1} from its checkpoint, then
    walks back through its steps carrying dS = ∂L/∂S_t (``dstate`` after
    the last step):

      dr_t[i]    = Σ_j dy_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
      dk_t[i]    = Σ_j dS[i,j] v_t[j] + u[i] r_t[i] (dy_t · v_t)
      dv_t[j]    = Σ_i dS[i,j] k_t[i] + (Σ_i r_t[i] u[i] k_t[i]) dy_t[j]
      dlogw_t[i] = w_t[i] Σ_j dS[i,j] S_{t-1}[i,j]
      du[i]     += Σ_b r_t[i] k_t[i] (dy_t · v_t)
      dS        ← diag(w_t) dS + r_tᵀ dy_t

    Returns (dr, dk, dv, dlogw (B, S, H, D), du (H, D)), all f32."""
    b, s, h, d = r.shape
    rf, kf, vf, dyf = (t.float() for t in (r, k, v, dy))
    wf = torch.exp(logw.float())
    uf = u.float()
    ds = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
          if dstate is None else dstate.float())
    dr, dk, dv, dlogw = (torch.zeros((b, s, h, d), dtype=torch.float32,
                                     device=r.device) for _ in range(4))
    du = torch.zeros((h, d), dtype=torch.float32, device=r.device)
    for c in reversed(range(-(-s // chunk))):
        t0, t1 = c * chunk, min(s, (c + 1) * chunk)
        state, prev = checkpoints[:, :, c].float(), []
        for t in range(t0, t1):
            prev.append(state)
            state = (wf[:, t, :, :, None] * state
                     + kf[:, t, :, :, None] * vf[:, t, :, None, :])
        for t in reversed(range(t0, t1)):
            sp = prev[t - t0]
            rt, kt, vt, wt, dyt = (x[:, t] for x in (rf, kf, vf, wf, dyf))
            dyv = (dyt * vt).sum(-1, keepdim=True)                 # (B, H, 1)
            dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, dyt) + uf * kt * dyv
            dk[:, t] = torch.einsum("bhij,bhj->bhi", ds, vt) + uf * rt * dyv
            dv[:, t] = (torch.einsum("bhij,bhi->bhj", ds, kt)
                        + (rt * uf * kt).sum(-1, keepdim=True) * dyt)
            dlogw[:, t] = wt * (ds * sp).sum(-1)
            du += (rt * kt * dyv).sum(0)
            ds = wt[..., None] * ds + rt[..., :, None] * dyt[..., None, :]
    return dr, dk, dv, dlogw, du


# ---------------------------------------------------------------------------
# fused_heads
# ---------------------------------------------------------------------------


def heads_topk(o, w_vocab, *, vocab: int, top_t: int = 4):
    """o: (N, d); w_vocab: (d, Vp).  Full-logits top-T over the logical
    vocab (lanes >= vocab are -1e30).  Returns (vals (N, T) f32, ids (N, T)
    int32)."""
    logits = o.float() @ w_vocab.float()
    lane = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(lane[None, :] < vocab, logits, NEG_INF)
    vals, ids = top_t_ids(logits, top_t)
    return vals, ids.to(torch.int32)


# ---------------------------------------------------------------------------
# fused_verify (materialized top-T + prefix-accept scan)
# ---------------------------------------------------------------------------


def fused_verify(p1_logits, proposals, *, criterion: str, top_k: int = 1,
                 epsilon: float = 0.0):
    """p1_logits: (B, k, V); proposals: (B, k) int32 (slot 0 = verified).

    Returns (accepts (B, k) bool, k̂ (B,) int32, accepted_tokens (B, k)
    int32, next_greedy (B,) int32).
    """
    if criterion not in CRITERIA:
        raise ValueError(f"unknown criterion {criterion!r}; one of {CRITERIA}")
    b, k, _ = p1_logits.shape
    top_t = max(1, int(top_k)) if criterion == "topk" else 1
    _, ids = top_t_ids(p1_logits.float(), top_t)
    greedy = ids[..., 0]                                    # (B, k)
    cand = proposals[:, 1:]
    if criterion == "exact":
        ok = cand == greedy[:, :k - 1]
    elif criterion == "topk":
        ok = torch.any(ids[:, :k - 1, :] == cand[..., None], dim=-1)
    else:
        ok = (cand - greedy[:, :k - 1]).abs().float() <= epsilon
    acc = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                device=ok.device), ok], dim=1)
    rej = ~acc
    first = torch.argmax(rej.to(torch.int32), dim=1)
    khat = torch.where(rej.any(dim=1), first, k).to(torch.int32)
    slot = torch.arange(k, device=acc.device)[None, :]
    toks = torch.where(slot < khat[:, None], proposals, 0).to(torch.int32)
    nxt = torch.gather(greedy, 1, (khat - 1).long()[:, None])[:, 0]
    return acc, khat, toks, nxt.to(torch.int32)
