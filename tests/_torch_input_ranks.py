"""What each spawned rank of ``test_torch_sharded_inputs.py`` runs.  A
module of its own (torch and the port only, no JAX), so that a rank
imports nothing of the reference.

``run`` is spawned once on a (2, 2) mesh of 4 CPU ranks.  Every rank makes
every mesh of the module first, in one order: (1, 2) over ranks 0, 1,
(2, 1) over ranks 2, 3, (1, 4) and the pod mesh (2, 1, 2) over all four.
The two pairs run side by side: each decodes every static case of the
module, then ranks 0, 1 serve the draft_model and locality engines over
(1, 2), and an input_copy engine whose requests carry their own ``src``,
while ranks 2, 3 serve the locality engine over (2, 1).  Then (2, 2)
and (1, 4) take all four for the static cases, and the pod mesh serves the
draft_model engine disaggregated, each pod prefilling its rows of a batch
(the draft's cache with them) and handing them to every rank over ``pod``.
On each mesh the ranks bridge the reference's weights into their blocks:
the encoder-decoder's both stacks and its cross attention, llava's
backbone, granite's and the drafts' trunks over ``model``.  ``run`` returns
{(mesh, config, case): this rank's result}.
"""
import numpy as np
import torch

import _torch_engine_ranks as engine_ranks
from repro_torch import bridge, serving
from repro_torch.config import DecodeConfig, ModelConfig
from repro_torch.core import ModelBundle
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as tmodel
from repro_torch.models import seq2seq
from repro_torch.sharding import comm

MAX_NEW, BLOCK_K = 12, 4
# the locality fixture's geometry: 8 x 8 fields in the lattice order of
# stride 2, decoded from their 16-token coarse prompt to the end
GRID = dict(image_height=8, image_width=8, locality_stride=2)
LOC_PROMPT, LOC_NEW = 16, 48
STATIC = {                    # config -> case -> DecodeConfig keywords
    "mt": {"greedy": {"block_k": 1}, "exact": {},
           "topk": {"policy": "topk", "top_k": 2},
           "topk_tree": {"policy": "topk_tree"},
           "input_copy": {"policy": "input_copy"}},
    "llava": {"exact_dense": {}, "exact_paged": {"cache_backend": "paged"},
              "draft_model": {"policy": "draft_model"}},
    "granite": {"draft_self": {"policy": "draft_model"},
                "draft_small": {"policy": "draft_model"}},
    "locality": {"locality": {"policy": "locality", "block_k": 4,
                              "max_new_tokens": LOC_NEW, **GRID}},
}
DRAFTS = {("llava", "draft_model"): "llava_draft",
          ("granite", "draft_small"): "granite_draft",
          ("granite", "draft_self"): "granite"}
STATIC_MESHES = ((1, 1, 2), (1, 2, 1), (1, 2, 2), (1, 1, 4))
# engine case -> (config, the draft's config or None, groups, mesh,
# DecodeConfig keywords, EngineConfig keywords)
DRAFT_GROUPS = {"draft_model": 2, "exact": 2}
LOC_GROUPS = {"locality": 2, "exact": 2}
COPY_GROUPS = {"input_copy": 2, "exact": 2}
# an input_copy request's src: its prompt and the reference's greedy
# continuation, so drafts copied from it are accepted in blocks
SRC_CAP = engine_ranks.PROMPT_CAP + MAX_NEW
ENGINES = {
    "draft small unified": ("granite", "granite_draft", DRAFT_GROUPS,
                            (1, 1, 2), {}, {}),
    "draft self unified": ("granite", "granite", DRAFT_GROUPS, (1, 1, 2),
                           {}, {}),
    "draft small disaggregated": ("granite", "granite_draft", DRAFT_GROUPS,
                                  (2, 1, 2), {},
                                  {"prefill_slots": 2, "handoff_cap": 4}),
    "draft self disaggregated": ("granite", "granite", DRAFT_GROUPS,
                                 (2, 1, 2), {},
                                 {"prefill_slots": 2, "handoff_cap": 4}),
    "locality (1, 2)": ("locality", None, LOC_GROUPS, (1, 1, 2),
                        {"max_new_tokens": LOC_NEW, **GRID}, {}),
    "locality (2, 1)": ("locality", None, LOC_GROUPS, (1, 2, 1),
                        {"max_new_tokens": LOC_NEW, **GRID}, {}),
    "input_copy (1, 2)": ("granite", None, COPY_GROUPS, (1, 1, 2), {},
                          {"max_prompt_len": SRC_CAP}),
}


def dec(name: str, case: str) -> dict:
    return dict(dict(max_new_tokens=MAX_NEW, block_k=BLOCK_K),
                **STATIC[name][case])


def engine_configs(case: str):
    """(DecodeConfig keywords, EngineConfig keywords) of an engine case."""
    name, _, groups, _, dkw, ekw = ENGINES[case]
    d = dict(dict(max_new_tokens=MAX_NEW, block_k=BLOCK_K), **dkw)
    prompt = LOC_PROMPT if name == "locality" else engine_ranks.PROMPT_CAP
    return d, dict(dict(num_slots=sum(groups.values()), max_prompt_len=prompt,
                        max_new_cap=d["max_new_tokens"]), **ekw)


def workload(case: str, streams=None):
    """An engine case's requests: (rid, prompt, max_new, arrival, policy).
    The draft cases take ``_torch_engine_ranks.workload``'s ten prompts,
    lengths, budgets and arrivals, their policies alternating draft_model
    and exact; the locality cases one request per fixture field, its
    coarse prompt and the rest of the field as the budget, four at time 0
    and four later."""
    name, _, groups, *_ = ENGINES[case]
    names = list(groups)
    if name != "locality":
        return [(rid, prompt, max_new, arrival, names[rid % 2])
                for rid, prompt, max_new, arrival, _ in engine_ranks.workload()]
    return [(rid, np.asarray(s[:LOC_PROMPT], np.int32), LOC_NEW,
             0.0 if rid < 4 else float(rid), names[rid % 2])
            for rid, s in enumerate(streams)]


def with_src(make_request, srcs):
    """``make_request`` that gives request ``rid`` its ``srcs[rid]`` (the
    others keep ``src=None``, their prompt)."""
    def make(rid, **kw):
        return make_request(rid=rid, src=srcs.get(rid), **kw)
    return make


def _params(mesh, payload, name):
    cfg_dict, np_params = payload["configs"][name]
    cfg = ModelConfig(**cfg_dict)
    return cfg, bridge.from_jax_params(np_params, cfg, device="cpu",
                                       mesh=mesh)


def _bundles(mesh, payload, draft, primary):
    """The ``draft`` bundle: the primary's own sharded tree (a
    self-draft), or the draft's whole bridged weights, which the session
    cuts (``sharding.shard_bundles``)."""
    cfg_dict, np_params = payload["configs"][draft]
    dcfg = ModelConfig(**cfg_dict)
    if primary is not None:
        return {"draft": ModelBundle(primary, dcfg)}
    return {"draft": ModelBundle(bridge.from_jax_params(
        np_params, dcfg, device="cpu"), dcfg)}


def batch_of(payload, name):
    """The decode batch of config ``name`` (host tensors)."""
    return {k: torch.as_tensor(v) for k, v in payload["batches"][name].items()}


def _static(mesh, payload, name, case):
    """One static case: this rank's (tokens, generated, text_len,
    iterations, invocations, mean_accepted) and what it keeps locally."""
    cfg, params = _params(mesh, payload, name)
    draft = DRAFTS.get((name, case))
    bundles = None if draft is None else _bundles(
        mesh, payload, draft, params if draft == name else None)
    sess = serving.DecodeSession(params, cfg, DecodeConfig(**dec(name, case)),
                                 mesh=mesh, bundles=bundles)
    batch = batch_of(payload, name)
    toks, st = (sess.decode_seq2seq(batch) if cfg.is_encoder_decoder
                else sess.decode(batch))
    local = {"kv_heads": tmodel.cache_config(sess.params, cfg).num_kv_heads}
    if bundles:
        drafter = sess.policy.drafter
        local.update(draft_kv_heads=drafter.cache_cfg.num_kv_heads,
                     self_draft=sess.aux_params["draft"] is sess.params,
                     draft_sharded=sess.aux_params["draft"].mesh is mesh)
    if cfg.is_encoder_decoder:     # the cross K/V of this rank's rows
        src = batch["src"][comm.data_rows(mesh, batch["src"].shape[0])]
        local["cross_kv"] = tuple(seq2seq.encode(sess.params, cfg,
                                                 src)[0].k.shape)
    return {"decode": (toks, st["generated"], st["text_len"],
                       st["iterations"], st["invocations"],
                       st["mean_accepted"]), "local": local}


def _engine(mesh, payload, case):
    """An engine case: rank 0 schedules on the virtual clock, the others
    replay its plans; this rank's records and counters."""
    name, draft, groups, *_ = ENGINES[case]
    cfg, params = _params(mesh, payload, name)
    bundles = None if draft is None else _bundles(
        mesh, payload, draft, params if draft == name else None)
    dec_kw, ecfg_kw = engine_configs(case)
    engine = serving.ContinuousBatchingEngine(
        params, cfg, DecodeConfig(**dec_kw), serving.EngineConfig(**ecfg_kw),
        mesh=mesh, bundles=bundles, policies=groups)
    if mesh.index == 0:
        done = engine_ranks.drive(serving.Scheduler(engine),
                                  workload(case, payload.get("streams")),
                                  with_src(serving.Request,
                                           payload["srcs"].get(case, {})))
        engine.release_followers()
    else:
        done = engine.follow()
    sess = engine.session
    return {"records": [engine_ranks.record(f) for f in done],
            "counters": engine_ranks.counters(engine),
            "handoff": (sess.handoffs, sess.handoff_bytes)}


def _all_static(mesh, shape, payload, out):
    for name, cases in STATIC.items():
        for case in cases:
            out[(shape, name, case)] = _static(mesh, payload, name, case)


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
    for case, (*_, at, _, _) in ENGINES.items():
        if at == shape:
            out[(shape, ENGINES[case][0], case)] = _engine(pair, payload, case)
    for shape in ((1, 2, 2), (1, 1, 4)):
        _all_static(meshes[shape], shape, payload, out)
    for case, (*_, at, _, _) in ENGINES.items():
        if at == (2, 1, 2):
            out[(at, ENGINES[case][0], case)] = _engine(meshes[at], payload,
                                                        case)
    return out
