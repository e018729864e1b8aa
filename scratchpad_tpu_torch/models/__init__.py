from scratchpad_tpu_torch.models.registry import get_model_class

__all__ = ["get_model_class"]
