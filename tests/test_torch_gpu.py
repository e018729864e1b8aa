"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where no CUDA device exists. This file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch; there, skip the JAX test configuration:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: |kernel - plain| <= 1e-4 + 2**-8 * |plain| on bf16 inputs, the
plain version computing in f32 and returning f32. Both kernels accumulate in
f32 and round only their output to bf16, which moves a value by at most
2**-8 of itself; 1e-4 covers the order of the f32 sums.
"""

import math

import pytest
import torch

from scratchpad_tpu_torch.ops.attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_extend_attention,
    paged_extend_attention_plain,
)

pytestmark = pytest.mark.gpu


ATOL, RTOL = 1e-4, 2.0**-8


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _pool(lens, Hkv, D, ps, gen):
    need = [max(-(-n // ps), 1) for n in lens]
    total = sum(need) + 1
    perm = torch.randperm(total - 1, generator=gen, device="cuda") + 1
    pt = torch.zeros(len(lens), max(need), dtype=torch.int32, device="cuda")
    o = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[o : o + n].to(torch.int32)
        o += n
    shape = (total, ps, Hkv, D)
    k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return k, v, pt


def _close(out, ref):
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and ref.dtype == torch.float32
    d = (out.float() - ref).abs()
    assert bool((d <= ATOL + RTOL * ref.abs()).all()), float(d.max())


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("lens", [[256, 0, 17, 200], [1500], [4096, 3000, 1]])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_decode_kernel_matches_plain(gen, D, lens, G):
    Hkv, ps = 4, 16
    k, v, pt = _pool(lens, Hkv, D, ps, gen)
    q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = paged_decode_attention(q, k, v, pt, seq, 1 / math.sqrt(D))
    _close(out, paged_decode_attention_plain(q.float(), k, v, pt, seq, 1 / math.sqrt(D)))
    assert bool((out[seq == 0] == 0).all())


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_extend_kernel_matches_plain(gen, D, G):
    Hkv, ps = 2, 16
    chunks = [(100, 100), (64, 600), (1, 33), (0, 0), (250, 250)]
    k, v, pt = _pool([c[1] for c in chunks], Hkv, D, ps, gen)
    q_lens = torch.tensor([c[0] for c in chunks], device="cuda")
    cu = torch.zeros(len(chunks) + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(q_lens, 0).to(torch.int32)
    kv_lens = torch.tensor([c[1] for c in chunks], dtype=torch.int32, device="cuda")
    T = int(cu[-1]) + 37  # padding tokens
    q = torch.randn(T, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    out = paged_extend_attention(q, k, v, pt, kv_lens, cu, 0.1)
    _close(out, paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, 0.1))
    assert bool((out[int(cu[-1]) :] == 0).all())


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    """A CUDA tensor reaches the kernel or raises; nothing falls back."""
    k, v, pt = _pool([40], 2, 64, 16, gen)
    seq = torch.tensor([40], dtype=torch.int32, device="cuda")
    q = torch.randn(1, 4, 64, device="cuda")
    with pytest.raises(TypeError):  # f32 q
        paged_decode_attention(q, k, v, pt, seq, 0.1)
    with pytest.raises(ValueError):  # head_dim 48
        paged_decode_attention(
            q[..., :48].bfloat16().contiguous(), k[..., :48].contiguous(),
            v[..., :48].contiguous(), pt, seq, 0.1,
        )
    with pytest.raises(TypeError):  # i64 page table
        paged_decode_attention(q.bfloat16(), k, v, pt.long(), seq, 0.1)
    cu = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):  # q on another device than the pool
        paged_extend_attention(q.bfloat16().cpu(), k, v, pt, seq, cu, 0.1)
