"""Static draft-tree topology + packed tree-attention masks (the port's own
copy of ``repro.kernels.tree_mask``; numpy only).

Tree verification (cf. arXiv:2404.09221, PAPERS.md) scores a whole candidate
tree of draft tokens in ONE verify forward instead of a single chain: each
tree node attends to its root-to-node ancestor chain (plus the committed
cache), so p_1's logits at node n are exactly the chain-conditioned
verification logits for n's token.  The topology is static (fixed per
policy, known at trace time), so everything derived here — depths, sibling
ranks, the ancestor matrix, the root-to-leaf path table, the packed per-row
ancestor bitmasks consumed by the tree-attention kernel — is plain numpy computed
once per (parents) tuple and cached.

This module is a *leaf*: it imports nothing from ``repro_torch.core`` or
``repro_torch.models`` so both sides (the ``TopKTreeDrafter`` in ``core.policy``
and the tree-masked attention in ``models.attention`` /
``kernels.block_attention``) can share one topology object without an
import cycle.

Node conventions (mirroring the block-slot conventions of core/policy.py):

  * Node 0 is the root and MUST carry the verified greedy token (the tree
    analogue of "slot 0 of every draft is the verified token"), so the
    accepted path always has length ≥ 1.
  * ``parents[n] < n`` — nodes are listed in topological (BFS-compatible)
    order; node n occupies block slot n in the verify forward, writing its
    KV at storage position ``length + n`` while attending at logical
    position ``length + depth[n]``.
  * With ``block_k`` nodes the tree forward has exactly the same width as
    the chain forward — mean-k̂ gains come at equal FLOPs per iteration.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

MAX_PACKED_NODES = 32  # packed ancestor bitmasks are int32 (bit n = node n)


@functools.lru_cache(maxsize=None)
def _derived(parents: Tuple[int, ...]):
    """All numpy tables derived from a parents tuple (cached per topology)."""
    n = len(parents)
    depth = np.zeros((n,), np.int32)
    for i in range(1, n):
        depth[i] = depth[parents[i]] + 1
    # sibling rank: i-th child (by node id) of the same parent
    seen: dict = {}
    rank = np.zeros((n,), np.int32)
    for i in range(1, n):
        rank[i] = seen.get(parents[i], 0)
        seen[parents[i]] = rank[i] + 1
    # ancestor-or-self matrix: anc[q, a] == True iff a is on q's root path
    anc = np.zeros((n, n), bool)
    for q in range(n):
        a = q
        while a >= 0:
            anc[q, a] = True
            a = parents[a]
    # path[q, d] = q's ancestor at depth d (-1 beyond q's own depth)
    max_depth = int(depth.max()) if n else 0
    path = np.full((n, max_depth + 1), -1, np.int32)
    for q in range(n):
        a = q
        while a >= 0:
            path[q, depth[a]] = a
            a = parents[a]
    bits = None
    if n <= MAX_PACKED_NODES:
        weights = (1 << np.arange(n, dtype=np.int64))
        bits = (anc.astype(np.int64) @ weights).astype(np.int64)
        bits = bits.astype(np.uint32).view(np.int32)  # wrap bit 31 safely
    return depth, rank, anc, path, bits


@dataclasses.dataclass(frozen=True)
class TreeTopology:
    """A static draft tree: node n's parent is ``parents[n]`` (root = -1)."""

    parents: Tuple[int, ...]

    def __post_init__(self):
        p = tuple(int(x) for x in self.parents)
        object.__setattr__(self, "parents", p)
        if not p or p[0] != -1:
            raise ValueError(f"node 0 must be the root (parents[0] == -1), "
                             f"got {p!r}")
        for i, a in enumerate(p[1:], start=1):
            if not 0 <= a < i:
                raise ValueError(f"parents must be topologically ordered "
                                 f"(0 <= parents[{i}] < {i}), got {a}")

    @property
    def num_nodes(self) -> int:
        return len(self.parents)

    @property
    def depths(self) -> np.ndarray:
        """(N,) int32 — node depths (root = 0)."""
        return _derived(self.parents)[0]

    @property
    def ranks(self) -> np.ndarray:
        """(N,) int32 — sibling rank of each node (i-th child of its parent)."""
        return _derived(self.parents)[1]

    @property
    def max_depth(self) -> int:
        return int(self.depths.max())

    @property
    def anc_matrix(self) -> np.ndarray:
        """(N, N) bool — anc[q, a] iff node a is on q's root path (self incl.)."""
        return _derived(self.parents)[2]

    @property
    def path_matrix(self) -> np.ndarray:
        """(N, max_depth+1) int32 — ancestor of node q at depth d, or -1."""
        return _derived(self.parents)[3]

    @property
    def anc_bits(self) -> np.ndarray:
        """(N,) int32 — packed ancestor bitmask per node (bit a of row q set
        iff ``anc_matrix[q, a]``), the layout the CUDA tree-attention
        kernel consumes.  Requires ≤ 32 nodes."""
        bits = _derived(self.parents)[4]
        if bits is None:
            raise ValueError(
                f"packed tree masks support at most {MAX_PACKED_NODES} "
                f"nodes, got {self.num_nodes}")
        return bits


def default_tree(block_k: int, fanout: int) -> TreeTopology:
    """The default verification tree for ``block_k`` nodes.

    Node 0 (root) carries the verified token; nodes 1..f (f = min(fanout,
    block_k-1)) are the root's children — the verifier gets ``f`` shots at
    the first speculative position; the remaining nodes form a top-1 chain
    below node 1.  Node 1's chain is exactly the classic heads chain
    (rank-0 candidate at every depth), so the tree's accepted path is
    never shorter than the chain's accepted prefix — up to the tree's own
    depth cap of ``block_k - f + 1``.
    """
    if block_k < 1:
        raise ValueError(f"block_k must be >= 1, got {block_k}")
    if block_k == 1:
        return TreeTopology((-1,))
    f = max(1, min(int(fanout), block_k - 1))
    parents = [-1] + [0] * f
    prev = 1
    for n in range(f + 1, block_k):
        parents.append(prev)
        prev = n
    return TreeTopology(tuple(parents))
