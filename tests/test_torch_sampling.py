"""The port's sampler against the JAX package's, on the CPU.

Greedy ids are compared bit for bit, penalties and the sort-free cutoff
(hence the kept tokens' probabilities) numerically, and sampled draws as a
distribution: ``torch.Generator`` and ``jax.random`` give different bits
from one seed, so both sides' empirical distributions are held to the
exact filtered one by total variation.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scratchpad_tpu.sampling.batch_info import SamplingBatchInfo as JaxInfo
from scratchpad_tpu.sampling.sampler import _fused_cutoff as jax_cutoff
from scratchpad_tpu.sampling.sampler import apply_penalties as jax_penalties
from scratchpad_tpu.sampling.sampler import sample as jax_sample
from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo
from scratchpad_tpu_torch.sampling.sampler import _fused_cutoff, apply_penalties, sample


def _infos(**arrays):
    """The same numpy sampling state as a JAX and a port SamplingBatchInfo."""
    jinfo = JaxInfo(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    return jinfo, SamplingBatchInfo(**arrays).to("cpu")


def _greedy_state(B, V, rng):
    return dict(
        temperature=np.zeros(B, np.float32),
        top_p=np.ones(B, np.float32),
        top_k=np.full(B, V, np.int32),
        min_p=np.zeros(B, np.float32),
    )


def test_greedy_bit_equal():
    rng = np.random.default_rng(0)
    B, V = 16, 1000
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    jinfo, info = _infos(**_greedy_state(B, V, rng))
    jids, jlp = jax_sample(jnp.asarray(logits), jinfo, jax.random.PRNGKey(0), full_logprobs=False)
    ids, lp = sample(torch.from_numpy(logits), info, None, full_logprobs=False)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    # the full log-softmax table too
    _, jfull = jax_sample(jnp.asarray(logits), jinfo, jax.random.PRNGKey(0))
    _, full = sample(torch.from_numpy(logits), info, None)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=1e-5, atol=1e-5)


def test_penalties_match():
    rng = np.random.default_rng(1)
    B, V = 6, 300
    logits = (rng.normal(size=(B, V)) * 2).astype(np.float32)
    state = dict(
        _greedy_state(B, V, rng),
        presence_penalty=rng.uniform(0, 1, B).astype(np.float32),
        frequency_penalty=rng.uniform(0, 1, B).astype(np.float32),
        repetition_penalty=rng.uniform(1, 2, B).astype(np.float32),
        output_token_counts=rng.integers(0, 3, (B, V)).astype(np.int32),
        input_token_mask=rng.random((B, V)) < 0.1,
    )
    jinfo, info = _infos(**state)
    want = np.asarray(jax_penalties(jnp.asarray(logits), jinfo))
    got = apply_penalties(torch.from_numpy(logits), info).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # and they steer greedy ids identically through sample()
    jids, _ = jax_sample(jnp.asarray(logits), jinfo, jax.random.PRNGKey(0), full_logprobs=False)
    ids, _ = sample(torch.from_numpy(logits), info, None, full_logprobs=False)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize(
    "top_k, top_p, min_p",
    [(20, 1.0, 0.0), (1000, 0.8, 0.0), (1000, 1.0, 0.05), (50, 0.9, 0.02), (1, 1.0, 0.0)],
)
def test_cutoff_probabilities_match(top_k, top_p, min_p):
    """Same cutoff, so the same kept set and the same renormalised
    probabilities of the kept tokens."""
    rng = np.random.default_rng(2)
    B, V = 8, 1000
    scaled = (rng.normal(size=(B, V)) * 2.5).astype(np.float32)
    k = np.full(B, top_k, np.int32)
    p = np.full(B, top_p, np.float32)
    m = np.full(B, min_p, np.float32)
    jcut = np.asarray(jax_cutoff(*(jnp.asarray(x) for x in (scaled, k, p, m))))
    cut = _fused_cutoff(*(torch.from_numpy(x) for x in (scaled, k, p, m))).numpy()
    np.testing.assert_allclose(cut, jcut, rtol=1e-5, atol=1e-5)

    def kept_probs(c):
        e = np.where(scaled >= c, np.exp(scaled - scaled.max(-1, keepdims=True)), 0.0)
        return e / e.sum(-1, keepdims=True)

    np.testing.assert_allclose(kept_probs(cut), kept_probs(jcut), atol=1e-6)


def test_sampled_distribution_tv():
    """Temperature + top-k + top-p + min-p draws: each side's empirical
    distribution is within total variation 0.03 of the exact filtered
    distribution (N = 20000 draws of one row; the sampling noise alone is
    about 0.01 at this support size)."""
    rng = np.random.default_rng(3)
    V, N = 64, 20000
    row = (rng.normal(size=V) * 1.5).astype(np.float32)
    temp, top_k, top_p, min_p = 0.8, 24, 0.9, 0.01
    state = dict(
        temperature=np.full(N, temp, np.float32),
        top_p=np.full(N, top_p, np.float32),
        top_k=np.full(N, top_k, np.int32),
        min_p=np.full(N, min_p, np.float32),
    )
    logits = np.broadcast_to(row, (N, V)).copy()
    jinfo, info = _infos(**state)
    jids, _ = jax_sample(jnp.asarray(logits), jinfo, jax.random.PRNGKey(7), full_logprobs=False)
    gen = torch.Generator().manual_seed(7)
    ids, _ = sample(torch.from_numpy(logits), info, gen, full_logprobs=False)

    # the exact distribution: sort-based top-k, top-p, min-p on row / temp
    s = row / temp
    probs = np.exp(s - s.max())
    probs /= probs.sum()
    order = np.argsort(-probs)
    keep = np.zeros(V, bool)
    keep[order[:top_k]] = True
    cum_before = np.cumsum(probs[order]) - probs[order]
    keep_p = np.zeros(V, bool)
    keep_p[order[cum_before < top_p]] = True
    keep &= keep_p & (probs >= probs.max() * min_p)
    exact = np.where(keep, probs, 0.0)
    exact /= exact.sum()

    for name, drawn in (("port", ids.numpy()), ("jax", np.asarray(jids))):
        emp = np.bincount(drawn, minlength=V) / N
        tv = 0.5 * np.abs(emp - exact).sum()
        assert tv < 0.03, (name, tv)
        assert not np.any(emp[~keep]), f"{name} drew a filtered token"
