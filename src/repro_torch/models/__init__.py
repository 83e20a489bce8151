"""LM-family models on torch: the plain decoder stack of the dense and
MoE families (twin of ``repro.models``)."""
from repro_torch.models.model_factory import Model, build_model, cross_entropy

__all__ = ["Model", "build_model", "cross_entropy"]
