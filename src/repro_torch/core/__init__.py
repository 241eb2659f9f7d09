"""Decode loop (``decode``), decode policies (``policy``) and BPD heads
(``heads``)."""
