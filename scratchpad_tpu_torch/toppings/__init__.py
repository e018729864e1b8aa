from scratchpad_tpu_torch.toppings.manager import MAX_ACTIVE_TOPPINGS, ToppingsManager

__all__ = ["ToppingsManager", "MAX_ACTIVE_TOPPINGS"]
