"""What each spawned rank of ``test_torch_sharded_families.py`` runs.  A
module of its own (torch and the port only, no JAX), so that a rank
imports nothing of the reference.

``run`` is spawned once on a (2, 2) mesh of 4 CPU ranks.  Every rank makes
every mesh of the module first, in one order: (1, 2) over ranks 0, 1,
(2, 1) over ranks 2, 3, (1, 4) and the pod mesh (2, 1, 2) over all four.
The two pairs run side by side (ranks 0, 1 then serve olmoe's requests
through the unified engine over (1, 2)), then (2, 2) and (1, 4) take all
four, and the pod mesh serves them through the disaggregated engine, each
pod prefilling its rows of a batch and handing them to every rank over
``pod``.  On each mesh the ranks bridge the reference's weights into their
blocks (experts, wkv heads and Mamba channels over ``model``).  ``run``
returns {(mesh, config, case): this rank's result}.
"""
import torch

import _torch_engine_ranks as engine_ranks
from repro_torch import bridge, serving
from repro_torch.config import DecodeConfig, ModelConfig
from repro_torch.core import decode as tdecode
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe

MAX_NEW, BLOCK_K = 12, 4
MOE = ("olmoe", "qwen2_moe", "qwen2_moe_padded")
DECODED = ("olmoe", "qwen2_moe", "rwkv6", "hymba")
CASES = {                       # case -> DecodeConfig keywords (BPD)
    "exact_dense": {},
    "exact_paged": {"cache_backend": "paged"},
    "topk": {"policy": "topk", "top_k": 2},
    # copy heads proposing p_1's token four times, accepted at a distance
    # of 48 ids: k̂ from 1 to 4 a row, so each per-step state is rolled to
    "distance": {"policy": "distance", "epsilon": 48.0},
    "topk_tree_dense": {"policy": "topk_tree"},
}
TREE_FAMILIES = ("olmoe", "qwen2_moe")        # tree verification: attention
STATIC_MESHES = ((1, 1, 2), (1, 2, 1), (1, 2, 2), (1, 1, 4))
ENGINE_CASES = {     # case -> (mesh, DecodeConfig keywords, EngineConfig keywords)
    "unified": ((1, 1, 2), {}, {}),
    "disaggregated": ((2, 1, 2), {}, {"prefill_slots": 2, "handoff_cap": 4}),
}


def dec(case: str) -> dict:
    return dict(max_new_tokens=MAX_NEW, block_k=BLOCK_K, **CASES.get(case, {}))


def cases(name: str):
    """The decodes of config ``name``: greedy and BPD's cases (the top-k
    tree on the attention families only)."""
    if name not in DECODED:
        return []
    return [c for c in CASES if c != "topk_tree_dense"
            or name in TREE_FAMILIES] + ["greedy"]


def engine_configs(case: str):
    """(DecodeConfig keywords, EngineConfig keywords) of an engine case."""
    _, dkw, ekw = ENGINE_CASES[case]
    return (dict(max_new_tokens=MAX_NEW, block_k=BLOCK_K, **dkw),
            dict(num_slots=sum(engine_ranks.GROUPS.values()),
                 max_prompt_len=engine_ranks.PROMPT_CAP, max_new_cap=MAX_NEW,
                 **ekw))


def routed_ids(cfg: ModelConfig, records):
    """{layer: (B, S, K) expert ids} of a forward's router logits."""
    return {layer: tmoe.top_experts(torch.softmax(logits, -1),
                                    cfg.num_experts_per_tok).numpy()
            for layer, _, logits in records}


def _static(mesh, payload, name):
    """Forward logits and routing, then every decode of config ``name``."""
    cfg_dict, np_params = payload["configs"][name]
    cfg = ModelConfig(**cfg_dict)
    params = bridge.from_jax_params(np_params, cfg, device="cpu", mesh=mesh)
    batch = {"tokens": torch.as_tensor(payload["prompts"])}
    records = []
    tmoe.ROUTER_TRACE = lambda layer, pos, logits: records.append(
        (layer, pos, logits))
    try:
        h = tmodel.embed_inputs(params, cfg, batch)
        hidden, _ = tmodel.forward_hidden(params, cfg, h,
                                          moe_full_capacity=True)
    finally:
        tmoe.ROUTER_TRACE = None
    ccfg = tmodel.cache_config(params, cfg)
    out = {"forward": tmodel.base_logits(params, cfg, hidden),
           "local": (ccfg.num_kv_heads, ccfg.wkv_heads, ccfg.ssm_channels,
                     tmoe.local_experts(params["blocks"][0]["moe"], cfg)
                     if name in MOE else None)}
    if name in MOE:
        out["routes"] = routed_ids(cfg, records)
    for case in cases(name):
        if case == "greedy":
            toks, st = tdecode.greedy_decode(
                params, cfg, DecodeConfig(**dec("")), batch, mesh=mesh)
        else:
            toks, st = tdecode.bpd_decode(
                params, cfg, DecodeConfig(**dec(case)), batch, mesh=mesh)
        out[case] = (toks, st["generated"], st["text_len"], st["iterations"])
    return out


def _engine(mesh, payload, case):
    """olmoe's requests through the sharded engine: rank 0 schedules on the
    virtual clock, the others replay its plans."""
    cfg_dict, np_params = payload["configs"]["olmoe"]
    cfg = ModelConfig(**cfg_dict)
    params = bridge.from_jax_params(np_params, cfg, device="cpu", mesh=mesh)
    dec_kw, ecfg_kw = engine_configs(case)
    engine = serving.ContinuousBatchingEngine(
        params, cfg, DecodeConfig(**dec_kw), serving.EngineConfig(**ecfg_kw),
        mesh=mesh, policies=engine_ranks.GROUPS)
    if mesh.index == 0:
        done = engine_ranks.drive(serving.Scheduler(engine),
                                  engine_ranks.workload(), serving.Request)
        engine.release_followers()
    else:
        done = engine.follow()
    sess = engine.session
    return {"records": [engine_ranks.record(f) for f in done],
            "counters": engine_ranks.counters(engine),
            "handoff": (sess.handoffs, sess.handoff_bytes)}


def _all_static(mesh, shape, payload, out):
    for name in payload["configs"]:
        for case, res in _static(mesh, payload, name).items():
            out[(shape, name, case)] = res


@torch.no_grad()
def run(mesh22, payload):
    """Every case on every mesh this rank belongs to (the meshes are made
    first, by every rank, in one order)."""
    meshes = {(1, 1, 2): make_mesh(1, 2, device="cpu", ranks=(0, 1)),
              (1, 2, 1): make_mesh(2, 1, device="cpu", ranks=(2, 3)),
              (1, 2, 2): mesh22,
              (1, 1, 4): make_mesh(1, 4, device="cpu"),
              (2, 1, 2): make_mesh(1, 2, pod=2, device="cpu")}
    out = {}
    pair = meshes[(1, 1, 2)] or meshes[(1, 2, 1)]
    shape = (1, 1, 2) if pair is meshes[(1, 1, 2)] else (1, 2, 1)
    _all_static(pair, shape, payload, out)
    if shape == (1, 1, 2):
        out[(shape, "olmoe", "engine unified")] = _engine(pair, payload,
                                                          "unified")
    for shape in ((1, 2, 2), (1, 1, 4)):
        _all_static(meshes[shape], shape, payload, out)
    out[((2, 1, 2), "olmoe", "engine disaggregated")] = _engine(
        meshes[(2, 1, 2)], payload, "disaggregated")
    return out
