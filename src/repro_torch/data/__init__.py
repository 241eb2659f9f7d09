from repro_torch.data.synthetic import MarkovLM

__all__ = ["MarkovLM"]
