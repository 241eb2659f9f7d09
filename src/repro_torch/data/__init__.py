from repro_torch.data.pipeline import prefetch, take, to_device
from repro_torch.data.synthetic import (CipherMT, MarkovLM, OrdinalCurves,
                                        OrdinalField, PhraseMT,
                                        locality_order, locality_plan)

__all__ = ["CipherMT", "MarkovLM", "OrdinalCurves", "OrdinalField", "PhraseMT",
           "locality_order", "locality_plan", "prefetch", "take", "to_device"]
