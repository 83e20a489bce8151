from repro_torch.data.pipeline import SyntheticLMData

__all__ = ["SyntheticLMData"]
