"""The greedy-margin guard of the port's parity tests (not a test module).

A parity test that compares greedy tokens of two frameworks asserts that the
port's top-2 logit margin exceeds its tolerance at every compared step, so a
near tie, where f32 rounding could flip the argmax between them, fails
loudly instead of flaking.
"""

import numpy as np

from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
from scratchpad_tpu_torch.executor.model_runner import WorkerBatch
from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo


def top2_margin(eng, prompt, out_ids, logit_bias=None) -> float:
    """The port engine's smallest top-2 logit margin over the generated steps
    of ``prompt`` + ``out_ids``, teacher-forced in one extend pass on pages
    borrowed from the idle engine (its argmax must be ``out_ids``), with
    ``logit_bias`` ({token id: bias}) added to the logits."""
    runner = eng.scheduler.runner
    toks = np.asarray(list(prompt) + list(out_ids))
    ps, n = runner.page_size, len(toks)
    pages = runner.page_allocator.alloc(-(-n // ps))
    pos = np.arange(n)
    try:
        wb = WorkerBatch(
            mode=ForwardMode.EXTEND, tokens=toks, positions=pos,
            out_cache_loc=pages[pos // ps] * ps + pos % ps, req_indices=np.zeros(n, np.int64),
            page_table=pages[None, :], seq_lens=np.array([n]), extend_lens=np.array([n]),
            sampling_info=SamplingBatchInfo.from_reqs([], 1, eng.model_config.vocab_size),
        )
        meta, _, _ = runner._pad_to_buckets(wb)
        meta.capture_all_hidden = True
        logits = runner.model.head_logits(runner.model(meta, runner.kv_cache))
    finally:
        runner.page_allocator.free(pages)
    steps = logits[len(prompt) - 1 : n - 1]
    for t, b in (logit_bias or {}).items():
        steps[:, int(t)] += b
    assert (steps.argmax(-1).numpy() == np.asarray(out_ids)).all()
    top2 = steps.topk(2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())
