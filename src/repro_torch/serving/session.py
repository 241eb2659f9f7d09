"""The engine's device functions for one (policy, geometry): a
``DecodeSession`` owns the parameters and builds, once per (policy,
``EngineConfig``), the serving functions of ``repro.serving.session`` on
one device.  Its ``decode`` / ``decode_seq2seq`` / ``greedy`` are the
run-to-completion entry points (``core.decode.bpd_decode`` /
``bpd_decode_seq2seq`` / ``greedy_decode``) under the session's policy and
``kv_chunk``.

``bundles`` ({name: ``core.bundle.ModelBundle``}) are the session's
auxiliary models, e.g. ``{"draft": ModelBundle(draft_params, draft_cfg)}``
for the ``draft_model`` policy.  The session takes them over: their
parameters are moved to the session's device and cast for their own
compute dtype in place (a self-draft shares the primary's tensors, so its
cfg must compute in the primary's dtype), and reach every prefill,
admission and step as ``aux``; their static half is bound into each policy the session serves
(``DecodePolicy.bind``), so an incompatible bundle fails at construction.

The reference jits each function once and donates the slot state between
calls.  Here each function is plain PyTorch, built (closed over its
geometry and policy) once per key and cached; ``builds`` counts the builds
per key, the twin of the reference's one-compile-per-geometry guard.  The
slot state's caches are written in place, as every cache of the port is;
the small per-slot tensors are replaced by each step and written in place
by ``attach`` / ``evict``.  Every policy's per-row state rides the same
generic scatter and evict reset (``_map``): the ``locality`` policy's
drafter ``grid`` and schedule ``pos`` as much as ``adaptive``'s ``rate`` and
``cap``, and ``draft_model``'s draft KV cache.  Capturing ``step`` as a CUDA
graph is ROADMAP.md §1 item 1; until then each call launches its kernels
from the host.

``mesh`` (this rank's ``launch.mesh.Mesh``) shards the session over a
("data", "model") or ("pod", "data", "model") process mesh, as the
reference's mesh-backed session does: the parameters over ``model``
(``sharding.shard_params``, unless they are sharded already, as
``model.init(mesh=)`` and ``bridge.from_jax_params(mesh=)`` make them).
``decode`` / ``greedy`` shard the batch and the per-row budgets over the
batch axes (``comm.data_rows``) and return the whole batch's tokens and
stats on every rank.  The serving functions keep this rank's slots of a
group (``ServingFns.local``: the slot slab over pod×data, or data alone,
``sharding.policy.batch_shard``):

  * ``init`` / ``step`` / ``evict`` run on those slots only; a window's
    ``go`` is the mesh-wide "no row harvestable" (``comm.any_row``);
  * ``prefill`` runs replicated over ``data`` (every rank prefills every
    row, as the reference's replicated admission prefill), and on a pod
    mesh each pod prefills its rows of a batch that divides the pod axis
    (``policy.prefill_axes``), which ``comm.pod_gather`` then hands to
    every rank: the prefill→decode KV handoff;
  * ``attach`` / ``attach_many`` / ``admit`` write a slot's rows only on
    the ranks that keep it.  The paged pool is replicated over pod×data as
    the reference's (``policy.cache_specs``), so an admission's pages —
    the prompt's pages, the only ones a copy-on-write hit can map — are
    written on every rank; decode-time pages are written by the slot's
    ranks and read by no other.

The sharded path runs what one device decodes (``model.
check_mesh_supported``): the dense trunk, the MoE models (experts over
``model``), RWKV-6 (wkv heads over ``model``), Hymba (Mamba channels over
``model``, attention replicated), llava's backbone (a rank's rows of the
patch prefix) and the encoder-decoder (``decode_seq2seq`` encodes a rank's
rows of the source, each rank the cross K/V of its own heads), under every
policy.  A recurrent family's rows and their per-step rollback are the
rank's rows over ``data``, its states at the rank's heads or channels
(``model.cache_config``); the engine serves decoder-only attention
families, on a mesh as on one device.  Each auxiliary bundle is cut by
the primary's rules (``sharding.shard_bundles``; a self-draft's bundle is
the primary's sharded tree), and a draft model's cache holds a rank's KV
heads of the draft.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.config import DecodeConfig, ModelConfig
from repro_torch.core import decode as decode_lib
from repro_torch.core import policy as policy_lib
from repro_torch.models import cache as cache_lib
from repro_torch.models import model as model_lib
from repro_torch.serving.types import EngineConfig, SlotBatch
from repro_torch.sharding import comm
from repro_torch.sharding.policy import (batch_shard, packet_pod,
                                         prefill_axes, shard_bundles,
                                         shard_params, slot_owner)

I32 = torch.int32


class PagedGeometry(NamedTuple):
    """Static page-pool geometry of a serving slot group: what the engine's
    host-side ``serving.pages.PageAllocator`` needs to mirror the device
    block tables."""

    page_size: int      # tokens per KV page
    pages_per_row: int  # block-table width P
    num_pages: int      # physical pool size (incl. trash page 0)
    prefix_len: int     # model prefix (meta tokens) before the prompt


class PrefillPacket(NamedTuple):
    """Finished prefill state of a batch of prompts before any slot is
    chosen: the unit of work a prefill worker hands to a decode group
    through the engine's KV-handoff queue.  Every leaf leads with the
    prefill width W; row i is one request's complete admission state."""

    tokens: Any        # (W, buf_len) slot token buffer rows (padded prompt)
    prompt_len: Any    # (W,) real prompt lengths
    proposals: Any     # (W, k) first-block draft proposals
    caches: Any        # prefilled caches, batch dim = W (dense row layout)
    policy_state: Any  # fresh per-row DecodePolicy state (W-leading leaves)


class ServingFn:
    """One built serving function and the number of times it was called
    (``compile_counts`` lists only the functions a run called)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


class ServingFns(NamedTuple):
    """The engine's device functions, built once per (policy, geometry).

    ``admit`` is ``attach ∘ prefill`` at width 1, so the unified engine's
    admission and the disaggregated engine's prefill-worker path run the
    same prefill body and the same scatter.  Host arrays go in (numpy,
    ints); each call makes one host-to-device copy of them.  ``aux`` is
    the session's {bundle name: params} of auxiliary models (``()`` for a
    single-model session): it goes wherever the policy may run a model of
    its own.
    """

    init: Callable      # (gid) -> SlotBatch
    admit: Callable     # (params, state, slot, prompt (P,), plen, max_new,
                        #  src (P,)[, tbl_row (Pg,), write_mask (Pg,)],
                        #  aux=()) -> state
    step: Callable      # (params, state, aux=()) -> (state, status (S,)
                        #  int8, iterations () int32), all on the device
    evict: Callable     # (state, mask (S,) bool) -> state
    prefill: Callable   # (params, prompts (W, P), plens (W,), srcs (W, P),
                        #  aux=()) -> PrefillPacket
    attach: Callable    # (state, packet, row, slot, max_new[, tbl_row,
                        #  write_mask]) -> state
    attach_many: Callable  # (state, packet, rows (W,), slots (W,),
                        #  max_news (W,), valid (W,)[, tbl_rows (W, Pg),
                        #  write_masks (W, Pg)]) -> state: the valid lanes
                        #  in one indexed write
    paged: Optional[PagedGeometry] = None   # page-pool geometry (None=dense)
    key: Any = None                         # the session's cache key
    local: slice = slice(None)              # the group's slots this rank
                                            # keeps (all of them on one
                                            # device)


def _map(fn, *trees):
    """``fn`` over the tensor leaves of policy-state trees of one structure
    (tensors, dicts, tuples and NamedTuples)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    vals = [_map(fn, *leaves) for leaves in zip(*trees)]
    return type(first)(*vals) if hasattr(first, "_fields") else type(first)(vals)


class DecodeSession:
    """Owner of the parameters and the engine's built serving functions.

    ``policy`` fixes the session's default decode policy, bound to
    ``bundles``; ``serving_fns(policy=...)`` builds functions for another
    policy's slot group, cached per (``DecodePolicy.cache_key``,
    ``EngineConfig``), so two groups that run equal policies at one
    geometry share one set.  The device is the parameters' device.
    ``kv_chunk`` > 0 runs every prefill's attention in chunks of that many
    keys (the reference's long-prefill bound).  ``mesh``: see the module.
    """

    def __init__(self, params, cfg: ModelConfig, dec: DecodeConfig, *,
                 mesh=None, kv_chunk: int = 0, policy=None, bundles=None):
        held = getattr(params, "mesh", None)
        mesh = held if mesh is None else mesh
        if mesh is not None:
            model_lib.check_mesh_supported(cfg, mesh)
            for b in (bundles or {}).values():
                model_lib.check_mesh_supported(b.cfg, mesh)
            whole = params
            if held is None:
                params = shard_params(params, mesh)
            elif held is not mesh:
                raise ValueError(f"params are sharded for {held}, not for "
                                 f"the session's {mesh}")
            bundles = shard_bundles(bundles or {}, mesh, whole, params)
        self.params = params
        self.cfg = cfg
        self.dec = dec
        self.kv_chunk = kv_chunk
        self.device = next(params.parameters()).device
        self.bundles = dict(bundles or {})
        for n, b in self.bundles.items():
            if b.params is params and b.cfg.compute_dtype != cfg.compute_dtype:
                raise ValueError(
                    f"bundle {n!r} shares the primary's parameters but "
                    f"computes in {b.cfg.compute_dtype}, the primary in "
                    f"{cfg.compute_dtype}: casting it would recast the "
                    f"primary's own tensors")
        self.policy = policy_lib.resolve_policy(dec, policy).bind(
            self.bundles, cfg)
        # each bundle on this device in its own compute dtype (in place: a
        # self-draft's bundle is the primary's ParamTree, not a copy)
        self.aux_params = {
            n: model_lib.cast_for_compute(b.params.to(self.device), b.cfg)
            for n, b in self.bundles.items()}
        self._fns: Dict[Any, ServingFns] = {}
        self.builds: Dict[Any, int] = {}   # serving-fns key -> builds
        # the pod handoff (``comm.pod_gather``): gathers, bytes a rank
        # received, and their host seconds (each waits for the prefill)
        self.handoffs = 0
        self.handoff_bytes = 0
        self.handoff_seconds = 0.0

    def decode(self, batch: Dict, *, max_new_rows=None):
        """Blockwise parallel decode of ``batch`` under the session's policy
        (``core.decode.bpd_decode``)."""
        rows = self._rows(batch)
        if max_new_rows is not None and rows is not None:
            max_new_rows = torch.as_tensor(max_new_rows, dtype=I32)[rows]
        out = decode_lib._bpd_decode_impl(
            self.params, self.cfg, self.dec, self._local(batch, rows),
            max_new_rows=max_new_rows, policy=self.policy,
            kv_chunk=self.kv_chunk, aux_params=self.aux_params)
        return self._whole(batch, out)

    def decode_seq2seq(self, batch: Dict):
        """Encode ``batch["src"]`` and BPD the decoder under the session's
        policy (``core.decode.bpd_decode_seq2seq``); on a mesh, this rank's
        rows of the source, and the whole batch's tokens and stats out."""
        out = decode_lib._bpd_decode_seq2seq_impl(
            self.params, self.cfg, self.dec,
            self._local(batch, self._rows(batch)), policy=self.policy,
            aux_params=self.aux_params)
        return self._whole(batch, out)

    def greedy(self, batch: Dict):
        """The greedy baseline (``core.decode.greedy_decode``)."""
        out = decode_lib._greedy_decode_impl(
            self.params, self.cfg, self.dec,
            self._local(batch, self._rows(batch)), kv_chunk=self.kv_chunk)
        return self._whole(batch, out)

    # -- the mesh's data axis --------------------------------------------------

    @property
    def mesh(self):
        """The mesh the parameters are sharded over (None on one device):
        the one the decode loop's collectives run on too."""
        return getattr(self.params, "mesh", None)

    @staticmethod
    def _batch_size(batch: Dict) -> int:
        """Rows of a decode batch: its prompts', or a seq2seq batch's
        sources'."""
        return batch["tokens" if "tokens" in batch else "src"].shape[0]

    def _rows(self, batch: Dict) -> Optional[slice]:
        """This rank's rows of ``batch`` (None without a mesh)."""
        if self.mesh is None:
            return None
        return comm.data_rows(self.mesh, self._batch_size(batch))

    @staticmethod
    def _local(batch: Dict, rows: Optional[slice]) -> Dict:
        return batch if rows is None else {k: v[rows] for k, v in batch.items()}

    def _whole(self, batch: Dict, out):
        """A decode's (tokens, stats) of this rank's rows -> the whole
        batch's, on every rank: tokens, ``generated`` and ``text_len``
        gathered over ``data``, ``mean_accepted`` over every row (the loop's
        ``iterations`` are the world's already)."""
        if self.mesh is None:
            return out
        toks, stats = out
        b = self._batch_size(batch)
        gen = comm.data_gather(self.mesh, stats["generated"], b)
        stats = dict(stats, generated=gen,
                     text_len=comm.data_gather(self.mesh, stats["text_len"], b),
                     mean_accepted=float(gen.sum()) / max(stats["iterations"],
                                                          1) / b)
        return comm.data_gather(self.mesh, toks, b), stats

    def bound_policy(self, policy=None):
        """Resolve ``policy`` (a registered name, a DecodePolicy, or None
        for the session default) and bind the session's bundles to it: the
        form every serving slot group runs."""
        if policy is None:
            return self.policy
        return policy_lib.resolve_policy(self.dec, policy).bind(
            self.bundles, self.cfg)

    def serving_fns(self, ecfg: EngineConfig, *, policy=None) -> ServingFns:
        """The engine's functions for ``policy`` at geometry ``ecfg``, built
        on first use and cached per (policy identity, geometry)."""
        pol = self.bound_policy(policy)
        key = ("serving", pol.cache_key, ecfg)
        fns = self._fns.get(key)
        if fns is None:
            fns = self._build_serving_fns(ecfg, pol)._replace(key=key)
            self._fns[key] = fns
            self.builds[key] = self.builds.get(key, 0) + 1
        return fns

    def _build_serving_fns(self, ecfg: EngineConfig, pol) -> ServingFns:
        cfg, dec, dev, mesh = self.cfg, self.dec, self.device, self.mesh
        block_k = dec.block_k or cfg.bpd_k
        # the prefix every request shares: the meta tokens.  The admission
        # batch carries tokens only, so no per-request patch prefix reaches
        # a shared page (the engine refuses modality != "text" besides)
        prefix = cfg.num_meta_tokens
        plen_max = ecfg.max_prompt_len
        context_len = prefix + plen_max + ecfg.max_new_cap
        buf_len = plen_max + ecfg.max_new_cap + block_k
        backend = decode_lib.causal_lm_backend(cfg)
        ccfg = model_lib.cache_config(self.params, cfg)   # the rank's KV heads
        s = ecfg.num_slots
        # this rank's slots of the group: [lo, lo + s_loc)
        shards, shard = (1, 0) if mesh is None else batch_shard(mesh, s)
        s_loc = s // shards
        lo = shard * s_loc
        local = slice(lo, lo + s_loc)

        paged_geom = None
        if dec.cache_backend == "paged":
            ps = dec.page_size
            n_pages = cache_lib.pages_per_row(context_len, block_k, ps)
            pool = ecfg.page_pool_pages or (1 + s * n_pages)
            kv_backend = cache_lib.get_backend(dec, num_pages=pool,
                                               managed=True)
            paged_geom = PagedGeometry(page_size=ps, pages_per_row=n_pages,
                                       num_pages=pool, prefix_len=prefix)
        else:
            kv_backend = cache_lib.get_backend(dec)

        def slots_batch(n: int) -> Dict:
            """The zeroed ``{"tokens", "src"}`` batch of the admission
            geometry that policy-state builders see, so state shapes are
            the same at init, admission and eviction."""
            z = torch.zeros((n, plen_max), dtype=I32, device=dev)
            return {"tokens": z, "src": z}

        # eviction's fresh per-row policy state (made once: it is constant)
        fresh = pol.init_state(cfg, dec, slots_batch(s_loc), s_loc)

        def to_device(*arrays) -> list:
            """The host arrays in one host-to-device copy, as int32 device
            tensors of their own shapes."""
            flat = [np.asarray(a).astype(np.int32).reshape(-1) for a in arrays]
            packed = torch.from_numpy(np.concatenate(flat))
            if dev.type == "cuda":      # pinned: the copy waits for no
                packed = packed.pin_memory()    # work queued before it
            packed = packed.to(dev, non_blocking=True)
            out, at = [], 0
            for a, f in zip(arrays, flat):
                out.append(packed[at:at + f.size].reshape(np.shape(a)))
                at += f.size
            return out

        def init_slots(gid) -> SlotBatch:
            zeros = lambda: torch.zeros((s_loc,), dtype=I32, device=dev)  # noqa: E731
            return SlotBatch(
                tokens=torch.zeros((s_loc, buf_len), dtype=I32, device=dev),
                text_len=zeros(),
                prompt_len=zeros(),
                proposals=torch.zeros((s_loc, block_k), dtype=I32, device=dev),
                caches=model_lib.init_caches(ccfg, s_loc, context_len, block_k,
                                             device=dev, backend=kv_backend),
                active=torch.zeros((s_loc,), dtype=torch.bool, device=dev),
                finished=torch.ones((s_loc,), dtype=torch.bool, device=dev),
                generated=zeros(),
                max_new=zeros(),
                invocations=zeros(),
                policy_state=pol.init_state(cfg, dec, slots_batch(s_loc),
                                            s_loc),
                group=torch.full((s_loc,), int(gid), dtype=I32, device=dev),
            )

        def handoff(packet: PrefillPacket, w: int) -> PrefillPacket:
            """Each pod's rows of ``packet`` to every rank (``comm.
            pod_gather``, one gather of every leaf's bytes)."""
            leaves = []
            _map(lambda t: leaves.append(t) or t, packet)
            t0 = time.perf_counter()
            whole, nbytes = comm.pod_gather(mesh, leaves, w)
            self.handoffs += 1
            self.handoff_bytes += nbytes
            self.handoff_seconds += time.perf_counter() - t0
            it = iter(whole)
            return _map(lambda _: next(it), packet)

        @torch.no_grad()
        def prefill(params, prompts, plens, srcs, aux=()) -> PrefillPacket:
            """The slot-free half of admission: prefill W padded prompts in
            one forward and return their handoff packet.  Rows never mix,
            so a packet row attached later is the state ``admit`` would
            install directly.  The per-row policy state is fresh and the
            policy's drafter proposes the first block from each row's last
            real position (a draft model prefills its own cache on the
            padded prompts, with its parameters from ``aux``).  On a pod
            mesh each pod prefills its rows of a batch that divides the pod
            axis, and every rank gets the whole packet (``handoff``)."""
            w = np.shape(prompts)[0]
            pods = mesh is not None and prefill_axes(mesh, w) is not None
            if pods:
                mine = [r for r in range(w)
                        if packet_pod(mesh, w, r) == mesh.coords["pod"]]
                prompts, plens, srcs = (np.asarray(a)[mine]
                                        for a in (prompts, plens, srcs))
            rows = np.shape(prompts)[0]
            prompts_d, srcs_d, plens_d = to_device(prompts, srcs, plens)
            row_caches = kv_backend.row_init(ccfg, context_len, block_k,
                                             batch=rows, device=dev)
            row_caches, proposals, row_ps = decode_lib.prefill_and_draft(
                params, cfg, dec, pol, {"tokens": prompts_d, "src": srcs_d},
                row_caches, plens_d, block_k, kv_chunk=self.kv_chunk,
                aux_params=aux)
            tokens = torch.zeros((rows, buf_len), dtype=I32, device=dev)
            tokens[:, :plen_max] = prompts_d
            packet = PrefillPacket(tokens=tokens, prompt_len=plens_d,
                                   proposals=proposals, caches=row_caches,
                                   policy_state=row_ps)
            return handoff(packet, w) if pods else packet

        def install(state: SlotBatch, packet: PrefillPacket, rows, slots,
                    max_news, tbl_rows=None, write_masks=None) -> SlotBatch:
            """Copy packet ``rows`` into the group's slots ``slots`` (host
            int arrays of one length; ``tbl_rows`` / ``write_masks`` the
            host allocator's (n, P) mappings), in place: every lane's pages
            into this rank's copy of the pool (replicated under a mesh),
            then the rows of the slots this rank keeps, their indices in
            the same host-to-device copy.  Every write copies out of the
            packet, so no slot aliases a packet row another lane still
            reads."""
            rows, slots, max_news = (np.asarray(a).reshape(-1)
                                     for a in (rows, slots, max_news))
            # this rank's lanes first, so that their indices are a prefix
            mine = np.array([mesh is None
                             or slot_owner(mesh, s, int(j)) == shard
                             for j in slots], bool)
            order = np.argsort(~mine, kind="stable")
            n = int(mine.sum())
            arrays = [rows[order], slots[order][:n] - lo, max_news[order][:n]]
            paged = tbl_rows is not None
            if paged:
                arrays += [np.asarray(a).reshape(len(order), -1)[order]
                           for a in (tbl_rows, write_masks)]
            dev_arrays = to_device(*arrays)
            rows_d = dev_arrays[0].long()
            row, slot, max_new = rows_d[:n], dev_arrays[1].long(), dev_arrays[2]
            tbl = None
            if paged:
                tbl = dev_arrays[3]
                model_lib.write_cache_pages(state.caches, packet.caches,
                                            rows_d, tbl, dev_arrays[4].bool())
                tbl = tbl[:n]
            if n == 0:
                return state
            plen = packet.prompt_len[row]
            state.tokens[slot] = packet.tokens[row]
            state.text_len[slot] = plen
            state.prompt_len[slot] = plen
            state.proposals[slot] = packet.proposals[row]
            model_lib.scatter_cache_row(state.caches, packet.caches, slot,
                                        row=row, tbl_row=tbl, pages=False)
            state.active[slot] = True
            state.finished[slot] = False
            state.generated[slot] = 0
            state.max_new[slot] = max_new
            state.invocations[slot] = 1          # the prefill call

            def put(full, row_vals):
                full[slot] = row_vals[row].to(full.dtype)

            _map(put, state.policy_state, packet.policy_state)
            return state

        def attach(state: SlotBatch, packet: PrefillPacket, row: int,
                   slot: int, max_new: int, tbl_row=None,
                   write_mask=None) -> SlotBatch:
            """The scatter-only half of admission: install packet ``row``
            into slot ``slot`` (the prefill→decode KV handoff).  Under the
            paged backend ``tbl_row`` / ``write_mask`` are the host
            allocator's mapping for this slot; copy-on-write prefix hits
            arrive with ``write_mask`` False and are left untouched."""
            paged = tbl_row is not None
            return install(state, packet, [row], [slot], [max_new],
                           [tbl_row] if paged else None,
                           [write_mask] if paged else None)

        def attach_many(state: SlotBatch, packet: PrefillPacket, rows, slots,
                        max_news, valid, tbl_rows=None,
                        write_masks=None) -> SlotBatch:
            """Batched KV handoff: the valid lanes' packet rows go into
            their slots in one indexed write per tensor (invalid lanes
            write nothing)."""
            lanes = np.nonzero(np.asarray(valid))[0]
            if lanes.size == 0:
                return state
            pick = lambda a: None if a is None else np.asarray(a)[lanes]  # noqa: E731
            return install(state, packet, pick(rows), pick(slots),
                           pick(max_news), pick(tbl_rows), pick(write_masks))

        def admit(params, state: SlotBatch, slot, prompt, prompt_len,
                  max_new, src, tbl_row=None, write_mask=None,
                  aux=()) -> SlotBatch:
            """Unified admission: ``attach ∘ prefill`` at width 1."""
            packet = prefill(params, np.asarray(prompt)[None],
                             np.asarray([prompt_len]), np.asarray(src)[None],
                             aux)
            return attach(state, packet, 0, slot, max_new, tbl_row,
                          write_mask)

        def one_step(params, state: SlotBatch, go, aux):
            """One BPD iteration over the slot batch.  ``go`` (a () bool
            device tensor, or None for True) masks every row: with go
            False all rows are frozen and the iteration changes nothing but
            speculative cache entries at positions >= text_len, which the
            next live iteration rewrites before it attends."""
            active = state.active if go is None else state.active & go
            bst = decode_lib.BPDState(
                tokens=state.tokens, text_len=state.text_len,
                proposals=state.proposals, caches=state.caches,
                finished=state.finished, iters=0,
                generated=state.generated, policy_state=state.policy_state)
            out = decode_lib.bpd_iteration(
                params, cfg, dec, backend, bst, prefix_offset=prefix,
                max_new=state.max_new, active=active, policy=pol,
                aux_params=aux)
            stepped = active & ~state.finished
            new_state = state._replace(
                tokens=out.tokens, text_len=out.text_len,
                proposals=out.proposals, caches=out.caches,
                finished=out.finished, generated=out.generated,
                invocations=state.invocations + stepped.to(I32),
                policy_state=out.policy_state)
            # the fused harvest decision: bit 0 = active, bit 1 = harvestable
            status = (state.active.to(torch.int8)
                      + 2 * (state.active & out.finished).to(torch.int8))
            return new_state, status

        k_win = ecfg.steps_per_sync

        def harvestable(status) -> torch.Tensor:
            """Whether any row of the group can be harvested: of every
            rank's slots under a mesh (one ``any_row`` over the slots)."""
            flag = torch.any((status & 2) > 0)
            return flag if mesh is None else comm.any_row(mesh, flag, s)

        @torch.no_grad()
        def step_windowed(params, state: SlotBatch, aux=()):
            """``steps_per_sync`` iterations in one call with no host read
            between them.  The reference's window is a device while_loop
            that exits once a row of the group can be harvested; here every
            iteration after that point runs with all rows frozen (``go``
            False, computed on the device, and mesh-wide under a mesh), so
            tokens, statuses and counts are those of the early exit.
            Returns (state, status of this rank's slots, iterations that
            did work), the last two on the device."""
            state, status = one_step(params, state, None, aux)
            iters = torch.ones((), dtype=I32, device=dev)
            for _ in range(k_win - 1):
                go = ~harvestable(status)
                state, status = one_step(params, state, go, aux)
                iters = iters + go.to(I32)
            return state, status, iters

        def evict(state: SlotBatch, mask) -> SlotBatch:
            """Retire rows ``mask`` — a host (S,) bool over the group's
            slots, or this rank's (S_loc,) device bool: inactive, KV rows
            invalidated in place (``pos`` -1, paged tables to the trash
            page) and the policy state of those rows fresh, so no slot
            leaks drafter or schedule history into its next request."""
            if not isinstance(mask, torch.Tensor):
                mask = torch.from_numpy(np.asarray(mask, bool)[local]).to(dev)
            model_lib.reset_cache_rows(state.caches, mask)

            def reset(full, init):
                rows = mask.reshape((-1,) + (1,) * (init.dim() - 1))
                return torch.where(rows, init, full)

            return state._replace(
                active=state.active & ~mask,
                policy_state=_map(reset, state.policy_state, fresh))

        return ServingFns(init=ServingFn(init_slots),
                          admit=ServingFn(admit),
                          step=ServingFn(step_windowed),
                          evict=ServingFn(evict),
                          prefill=ServingFn(prefill),
                          attach=ServingFn(attach),
                          attach_many=ServingFn(attach_many),
                          paged=paged_geom, local=local)
