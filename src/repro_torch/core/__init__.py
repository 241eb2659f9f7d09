"""Decode loop (``decode``), decode policies (``policy``), the draft-model
drafter (``draft``) with its ``ModelBundle`` (``bundle``) and BPD heads
(``heads``).

``DraftModelDrafter`` is imported from ``core.draft``: it needs the model
stack, and ``models.model`` imports ``core.heads`` while this package is
still initializing."""
from repro_torch.core.bundle import ModelBundle

__all__ = ["ModelBundle"]
