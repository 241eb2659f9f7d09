"""What each spawned rank of ``test_torch_sharded_decode.py`` runs.  A
module of its own (torch and the port only, no JAX), so that a rank
imports nothing of the reference.

``run`` is spawned once on a (2, 2) mesh of 4 CPU ranks; it also makes the
(1, 2), (2, 1) and (1, 4) meshes over the first ranks, and on each mesh it
bridges the reference's weights into this rank's blocks and runs every
case, returning {mesh: {(config, case): result}}.
"""
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.config import DecodeConfig, ModelConfig
from repro_torch.core import decode as tdecode
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as tmodel
from repro_torch.sharding import comm

MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
MAX_NEW, BLOCK_K = 12, 4
BUDGETS = (3, 12, 7, 5)
CASES = {                       # case -> DecodeConfig keywords (BPD)
    "exact_dense": {},
    "exact_paged": {"cache_backend": "paged"},
    "topk": {"policy": "topk", "top_k": 2},
    "distance": {"policy": "distance", "epsilon": 2.0},
    "adaptive": {"policy": "adaptive"},
    "topk_tree_dense": {"policy": "topk_tree"},
    "budgets": {},              # exact with per-row budgets BUDGETS
}
TOP_T = 4


def dec(case: str) -> dict:
    return dict(max_new_tokens=MAX_NEW, block_k=BLOCK_K,
                **CASES.get(case, {}))


def planted(np_params: dict, cfg: ModelConfig) -> dict:
    """``np_params`` with a vocab projection of small integers whose lanes
    3 and vocab - 2 are equal and the largest: an exact tie of the two top
    logits of any positive ``o``, across two shards at model 4 (and at
    model 2 where the vocab reaches past the first shard)."""
    rng = np.random.default_rng(11)
    vp, d = cfg.padded_vocab_size, cfg.d_model
    w = rng.integers(-2, 3, (vp, d)).astype(np.float32)
    w[3] = w[cfg.vocab_size - 2] = 4.0
    if cfg.tie_embeddings:
        return dict(np_params, embed={"table": w})
    return dict(np_params, lm_head={"w": np.ascontiguousarray(w.T)})


def _decodes(params, cfg, batch, mesh):
    out = {}
    for case in CASES:
        rows = list(BUDGETS) if case == "budgets" else None
        toks, st = tdecode.bpd_decode(params, cfg, DecodeConfig(**dec(case)),
                                      batch, max_new_rows=rows, mesh=mesh)
        out[case] = (toks, st["generated"], st["text_len"], st["iterations"])
    toks, st = tdecode.greedy_decode(params, cfg, DecodeConfig(**dec("")),
                                     batch, mesh=mesh)
    out["greedy"] = (toks, st["generated"], st["text_len"], st["iterations"])
    return out


def _row_sums(mesh, payload):
    """``comm.row_sum`` in bf16 on this rank's columns of x and rows of w,
    in both forms: {form: (N, d) or (k, N, d) result}."""
    m, i = mesh.shape["model"], mesh.coords["model"]
    out = {}
    for form, (x, w) in payload["row_sum"].items():
        n = w.shape[-2] // m
        x = torch.as_tensor(x).bfloat16()[..., i * n:(i + 1) * n]
        w = torch.as_tensor(w).bfloat16()[..., i * n:(i + 1) * n, :]
        out[form] = comm.row_sum(mesh, x, w)
    return out


@torch.no_grad()
def _one_mesh(mesh, payload):
    out = {("row_sum", form): y
           for form, y in _row_sums(mesh, payload).items()}
    batch = {"tokens": torch.as_tensor(payload["prompts"])}
    for name, (cfg_dict, np_params) in payload["configs"].items():
        cfg = ModelConfig(**cfg_dict)
        params = bridge.from_jax_params(np_params, cfg, device="cpu",
                                        mesh=mesh)
        h = tmodel.embed_inputs(params, cfg, batch)
        hidden, _ = tmodel.forward_hidden(params, cfg, h)
        out[(name, "forward")] = tmodel.base_logits(params, cfg, hidden)
        for case, res in _decodes(params, cfg, batch, mesh).items():
            out[(name, case)] = res
        # head_topk: the merged ids against one rank's whole-vocab launch
        whole = bridge.from_jax_params(np_params, cfg, device="cpu")
        hid = torch.as_tensor(payload["hidden"][name])
        out[(name, "head_topk")] = (
            tmodel.head_topk(params, cfg, hid, cfg.bpd_k - 1, TOP_T),
            tmodel.head_topk(whole, cfg, hid, cfg.bpd_k - 1, TOP_T))
        tie = planted(np_params, cfg)
        o = torch.as_tensor(payload["o"][name])
        out[(name, "planted_tie")] = (
            tmodel.vocab_top_t(bridge.from_jax_params(
                tie, cfg, device="cpu", mesh=mesh), cfg, o, TOP_T),
            tmodel.vocab_top_t(bridge.from_jax_params(
                tie, cfg, device="cpu"), cfg, o, TOP_T))
    return out


def run(mesh22, payload):
    """Every case on every mesh this rank belongs to (the meshes are made
    first, by every rank, in one order)."""
    meshes = {shape: (mesh22 if shape == (2, 2) else make_mesh(
        *shape, device="cpu", ranks=range(shape[0] * shape[1])))
        for shape in MESHES}
    return {shape: _one_mesh(m, payload) for shape, m in meshes.items()
            if m is not None}


def fail_or_hang(mesh, how: str):
    """Rank 1 raises (``how`` "raise") or sleeps past any time limit
    ("hang"); rank 0 returns its index."""
    if mesh.index == 1:
        if how == "raise":
            raise ValueError("rank 1 was told to fail")
        time.sleep(600)
    return mesh.index
