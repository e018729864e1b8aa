"""Batched sampling state for one step.

Counterpart of ``scratchpad_tpu/sampling/batch_info.py``: host numpy arrays
built from the scheduler's requests (``from_reqs``), moved to the device by
``to(device)``. Padding rows are greedy. A grammar's allow-mask rides in
``vocab_bitmask``, which the runner fills from the scheduler's batch.
Custom logit processors (``sampling/custom_logit_processor.py``) ride as the
batch's distinct processors, a row mask for each and each one's per-row
params.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class SamplingBatchInfo:
    temperature: np.ndarray  # f32[B] (0 = greedy)
    top_p: np.ndarray  # f32[B]
    top_k: np.ndarray  # i32[B] (V for disabled)
    min_p: np.ndarray  # f32[B]
    # penalties (None when no request in the batch uses them)
    presence_penalty: Optional[np.ndarray] = None  # f32[B]
    frequency_penalty: Optional[np.ndarray] = None  # f32[B]
    repetition_penalty: Optional[np.ndarray] = None  # f32[B]
    output_token_counts: Optional[np.ndarray] = None  # i32[B, V]
    input_token_mask: Optional[np.ndarray] = None  # bool[B, V]
    # additive OpenAI logit_bias (None when no request in the batch has one)
    logit_bias: Optional[np.ndarray] = None  # f32[B, V]
    # grammar allow-mask (None when no request in the batch has a grammar)
    vocab_bitmask: Optional[np.ndarray] = None  # u32[B, ceil(V / 32)]
    # custom logit processors (None when no request in the batch has one):
    # the batch's distinct processors in the order first seen; row mask i
    # marks processor i's rows, and params i holds one f32[B] array a key
    # of its requests' custom_params (0 on the rows without it)
    custom_processors: Optional[tuple] = None
    custom_proc_mask: Optional[np.ndarray] = None  # bool[P, B]
    custom_proc_params: Optional[tuple] = None  # tuple[dict[str, f32[B]]]

    # the fields that are not one array: the processors and their params'
    # dicts of arrays
    HOST_FIELDS = ("custom_processors", "custom_proc_params")

    @property
    def needs_penalties(self) -> bool:
        return self.output_token_counts is not None

    def modes(self, vocab_size: int) -> tuple[bool, bool]:
        """(any row samples, any row filters by top-k/top-p/min-p)."""
        sampling = bool((self.temperature > 0).any())
        filtering = bool(
            ((self.top_k < vocab_size) | (self.top_p < 1.0) | (self.min_p > 0.0)).any()
        )
        return sampling, filtering

    def to(self, device) -> "SamplingBatchInfo":
        """Tensor copy of every present field on ``device`` (the processors
        as they are, their params' arrays as tensors)."""
        return self.map_arrays(lambda a: torch.as_tensor(a).to(device))

    def map_arrays(self, fn) -> "SamplingBatchInfo":
        """A copy with ``fn`` applied to every present array, the
        processors' params included; the processors themselves are kept."""
        out = {
            f.name: None if getattr(self, f.name) is None else fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if f.name not in self.HOST_FIELDS
        }
        params = self.custom_proc_params
        return SamplingBatchInfo(
            **out,
            custom_processors=self.custom_processors,
            custom_proc_params=None if params is None
            else tuple({k: fn(v) for k, v in d.items()} for d in params),
        )

    @staticmethod
    def from_reqs(reqs, bucket_size: int, vocab_size: int) -> "SamplingBatchInfo":
        """Build padded host arrays from scheduler Req objects."""
        B = bucket_size
        temperature = np.zeros(B, np.float32)
        top_p = np.ones(B, np.float32)
        top_k = np.full(B, vocab_size, np.int32)
        min_p = np.zeros(B, np.float32)
        any_pen = any(r.sampling_params.needs_penalties() for r in reqs)
        pres = np.zeros(B, np.float32) if any_pen else None
        freq = np.zeros(B, np.float32) if any_pen else None
        rep = np.ones(B, np.float32) if any_pen else None
        for i, r in enumerate(reqs):
            sp = r.sampling_params
            temperature[i] = sp.temperature
            top_p[i] = sp.top_p
            top_k[i] = sp.top_k if sp.top_k > 0 else vocab_size
            min_p[i] = sp.min_p
            if any_pen:
                pres[i] = sp.presence_penalty
                freq[i] = sp.frequency_penalty
                rep[i] = sp.repetition_penalty
        bias = None
        if any(r.sampling_params.logit_bias for r in reqs):
            bias = np.zeros((B, vocab_size), np.float32)
            for i, r in enumerate(reqs):
                for tid, b in (r.sampling_params.logit_bias or {}).items():
                    if 0 <= int(tid) < vocab_size:
                        bias[i, int(tid)] = b
        out_counts = None
        in_mask = None
        if any_pen:
            out_counts = np.zeros((B, vocab_size), np.int32)
            in_mask = np.zeros((B, vocab_size), np.bool_)
            for i, r in enumerate(reqs):
                if r.output_ids:
                    ids, counts = np.unique(
                        np.asarray(r.output_ids, np.int64), return_counts=True
                    )
                    out_counts[i, ids] = counts
                # a vision prompt's placeholders are negative ids: they
                # mark no token of the vocabulary
                ids = np.asarray(r.origin_input_ids, np.int64)
                in_mask[i, ids[ids >= 0]] = True
        procs = mask = pparams = None
        if any(r.sampling_params.custom_logit_processor is not None for r in reqs):
            groups: dict = {}  # processor -> its rows, in the order first seen
            for i, r in enumerate(reqs):
                proc = r.sampling_params.custom_logit_processor
                if proc is not None:
                    groups.setdefault(proc, []).append(i)
            procs = tuple(groups)
            mask = np.zeros((len(procs), B), np.bool_)
            pparams = []
            for pi, rows in enumerate(groups.values()):
                mask[pi, rows] = True
                d = {}
                for i in rows:
                    for k, v in (reqs[i].sampling_params.custom_params or {}).items():
                        d.setdefault(k, np.zeros(B, np.float32))[i] = float(v)
                pparams.append(dict(sorted(d.items())))
            pparams = tuple(pparams)
        return SamplingBatchInfo(
            temperature=temperature,
            top_p=top_p,
            top_k=top_k,
            min_p=min_p,
            presence_penalty=pres,
            frequency_penalty=freq,
            repetition_penalty=rep,
            output_token_counts=out_counts,
            input_token_mask=in_mask,
            logit_bias=bias,
            custom_processors=procs,
            custom_proc_mask=mask,
            custom_proc_params=pparams,
        )
