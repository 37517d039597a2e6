from repro_torch.models.model import LM, make_model

__all__ = ["LM", "make_model"]
