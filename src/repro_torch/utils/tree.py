"""Parameter-tree helpers, as in ``repro.utils.tree``.

A tree is a ``ParamTree`` (its ``named_parameters()``) or nested dicts /
lists of tensors.  Leaves are named by the reference's ``/`` paths
(``bpd_heads/w1``, ``blocks/0/attn/wq``), so a mask or a rule table keyed
by name reads the same in both packages.  Where the reference maps a
pytree to a pytree of the same structure, these helpers return a flat dict
keyed by those names.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch
from torch import nn


def flatten_with_names(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    """[('blocks/0/attn/wq', leaf), ...] in the tree's own order."""
    if isinstance(tree, nn.Module):
        return [(name.replace(".", "/"), p)
                for name, p in tree.named_parameters()]
    out: List[Tuple[str, torch.Tensor]] = []

    def visit(prefix, node):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out.append((prefix, node))
            return
        for key, val in items:
            visit(f"{prefix}/{key}" if prefix else str(key), val)

    visit("", tree)
    return out


def tree_map_with_name(fn: Callable[[str, Any], Any], tree: Any) -> Dict[str, Any]:
    """{name: fn(name, leaf)} over the tree's leaves."""
    return {name: fn(name, leaf) for name, leaf in flatten_with_names(tree)}


def tree_size(tree: Any) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(leaf.numel() for _, leaf in flatten_with_names(tree))


def global_norm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of ``leaves``, an fp32
    scalar on the leaves' device (no host read).  Accumulated in float64:
    PyTorch's fp32 norm of a tensor of millions of elements on the CPU
    drifts far past fp32 rounding, where the reference's fp32 sum does
    not."""
    norms = [torch.linalg.vector_norm(x, dtype=torch.float64) for x in leaves]
    if not norms:
        return torch.zeros(())
    return torch.stack(norms).square().sum().sqrt().float()
