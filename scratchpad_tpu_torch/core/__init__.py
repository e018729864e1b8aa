from scratchpad_tpu_torch.core.req import Req, FinishReason
from scratchpad_tpu_torch.core.scheduler import Scheduler

__all__ = ["Req", "FinishReason", "Scheduler"]
