from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode

__all__ = ["ForwardMeta", "ForwardMode"]
