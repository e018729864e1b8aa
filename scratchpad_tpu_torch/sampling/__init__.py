from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo

__all__ = ["SamplingParams", "SamplingBatchInfo"]
