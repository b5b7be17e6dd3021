"""The LM stack: layers, attention, the decoder and its model API."""
from repro_torch.models.factory import Model, build_model  # noqa

__all__ = ["Model", "build_model"]
