"""Verification criteria: the removed entry points of ``repro.core.verify``.

The paper's acceptance criteria (§3 exact match, §5.1 top-k, §5.2
distance, §5.3 minimum block size) are ``Acceptor`` / ``BlockSchedule``
objects of ``core.policy``, composed into a ``DecodePolicy`` and resolved
by ``repro_torch.core.policy.resolve_policy``.  The criterion-string
functions that lived here raise, as the reference's do, and name that path:

    from repro_torch.core.policy import resolve_policy
    policy = resolve_policy(dec)                   # or resolve_policy(dec, name)
    accepts = policy.acceptor.accepts(proposals, p1_logits)
    khat, state = policy.schedule.block_size(accepts, remaining, state)
"""
from __future__ import annotations


def _removed(name: str, call: str) -> ValueError:
    return ValueError(
        f"repro_torch.core.verify.{name} was removed: the criterion-string "
        f"API is gone.  Resolve a DecodePolicy via "
        f"repro_torch.core.policy.resolve_policy(dec) and call {call} "
        f"instead.")


def position_accepts(*_args, **_kwargs):
    """REMOVED: use ``resolve_policy(dec).acceptor.accepts(proposals,
    p1_logits)``."""
    raise _removed("position_accepts",
                   "policy.acceptor.accepts(proposals, p1_logits)")


def accepted_block_size(*_args, **_kwargs):
    """REMOVED: use ``resolve_policy(dec).schedule.block_size(accepts,
    remaining, state)``."""
    raise _removed("accepted_block_size",
                   "policy.schedule.block_size(accepts, remaining, state)")
