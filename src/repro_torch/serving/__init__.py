"""LM serving on torch (twin of ``repro.serving``)."""
from repro_torch.serving.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
