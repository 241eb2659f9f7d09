from repro_torch.data.pipeline import prefetch, take, to_device
from repro_torch.data.synthetic import CipherMT, MarkovLM, PhraseMT

__all__ = ["CipherMT", "MarkovLM", "PhraseMT", "prefetch", "take", "to_device"]
