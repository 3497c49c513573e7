"""PyTorch port, attention kernel's plain version and autograd wrapper vs the
JAX package: the port's ``flash_attention`` on CPU tensors (its plain
chunked online softmax, ``kernels/flash_attention/ref.py``) against the JAX
``flash_attention`` through the Pallas kernel (interpret mode on the CPU,
as its own test runs it) and through its oracle, on the JAX kernel test's
shape sweep, its gradient check, its Skv 9000 case and a bfloat16 case.

Tolerances: float32 outputs and gradients at atol 2e-5, rtol 2e-4 (the JAX
kernel test's). bfloat16 outputs are compared with the JAX oracle as the
two round them: at most one bfloat16 step apart (2^-7 relative at most),
and at least 99% bitwise equal, which pins the order the oracle takes (q
cast to float32, then scaled; scaling in bfloat16 first leaves only ~60%
equal and many entries two steps apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.models.common import chunked_attention as j_chunked
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref

from torch_port_helpers import np_

CASES = [
    # (B, S, Skv, H, Hkv, hd, causal, window), as in tests/test_flash_attention_kernel.py
    (2, 128, 128, 4, 4, 64, True, None),
    (1, 256, 256, 4, 2, 32, True, None),
    (2, 128, 128, 2, 2, 64, True, 32),
    (1, 64, 128, 2, 2, 32, True, None),   # q shorter than kv (q_offset)
    (1, 128, 128, 4, 1, 64, False, None), # bidirectional, MQA
    (1, 100, 100, 2, 2, 64, True, None),  # non-BQ-multiple S
]
ATOL, RTOL = 2e-5, 2e-4


def _mk(b, s, skv, h, hkv, hd, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, s, h, hd)).astype(np.float32),
            r.normal(size=(b, skv, hkv, hd)).astype(np.float32),
            r.normal(size=(b, skv, hkv, hd)).astype(np.float32))


def _jit(backend, causal, window, q_offset):
    return jax.jit(lambda q, k, v: j_flash(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                           backend=backend))


@pytest.mark.parametrize("b,s,skv,h,hkv,hd,causal,window", CASES)
def test_forward_matches_jax_pallas_and_oracle(b, s, skv, h, hkv, hd, causal, window):
    q, k, v = _mk(b, s, skv, h, hkv, hd, seed=s)
    off = skv - s
    got = np_(flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window, q_offset=off))
    for backend in ("pallas", "ref"):
        want = np.asarray(_jit(backend, causal, window, off)(q, k, v))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=backend)


def test_grads_match_jax():
    q, k, v = _mk(1, 128, 128, 2, 2, 32, seed=7)

    def j_loss(backend):
        return jax.jit(jax.grad(lambda q, k, v: jnp.sum(jnp.tanh(j_flash(q, k, v, backend=backend))),
                                argnums=(0, 1, 2)))

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    torch.tanh(flash_attention(*leaves)).sum().backward()
    for backend in ("pallas", "ref"):
        for got, want in zip(leaves, j_loss(backend)(q, k, v)):
            np.testing.assert_allclose(np_(got.grad), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=backend)


def test_long_skv_matches_jax():
    """Skv 9000: past the Pallas kernel's residency limit (JAX falls back to
    its oracle there); the port has no limit and no fallback."""
    q, k, v = _mk(1, 64, 9000, 1, 1, 32, seed=3)
    off = 9000 - 64
    got = np_(flash_attention(*map(torch.from_numpy, (q, k, v)), q_offset=off))
    want = np.asarray(_jit("pallas", True, None, off)(q, k, v))
    assert got.shape == (1, 64, 1, 32) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_bf16_matches_jax_chunked_attention_at_hd128():
    """bfloat16 at hd 128 (the Qwen3 head width, where the scale 1/sqrt(128)
    is not a power of two): the oracle casts q to float32 before scaling (its
    NumPy float64 scale promotes the product), and so does the port."""
    b, s, h, hkv, hd = 2, 96, 4, 2, 128
    q, k, v = _mk(b, s, s, h, hkv, hd, seed=11)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax.jit(lambda q, k, v: j_chunked(q, k, v))(jq, jk, jv).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in (jq, jk, jv))
    out = flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    got = np_(out.to(torch.float32))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=2.0 ** -7)
    assert (got == want).mean() >= 0.99


def test_function_matches_autograd_of_the_plain_version():
    """The wrapper's backward (the plain version's VJP, recomputed) equals
    autograd through the plain version itself, with a window and GQA."""
    q, k, v = _mk(2, 40, 72, 4, 2, 32, seed=5)
    g = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    kw = dict(causal=True, window=24, q_offset=32)
    grads = []
    for fn in (flash_attention, attention_ref):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        (fn(*leaves, **kw) * torch.from_numpy(g)).sum().backward()
        grads.append([np_(x.grad) for x in leaves])
    for a, b_ in zip(*grads):
        np.testing.assert_allclose(a, b_, atol=1e-6, rtol=1e-6)


def test_kernel_launch_refuses_cpu_tensors_and_rowless_masks():
    q, k, v = map(torch.from_numpy, _mk(1, 8, 8, 1, 1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.launch(q, k, v)
    assert fa_ops._rows_reach_a_key(8, 8, True, None, 0)
    assert fa_ops._rows_reach_a_key(8, 8, True, 4, 0)
    assert not fa_ops._rows_reach_a_key(8, 8, True, None, -1)     # row 0 at position -1: no key
    assert not fa_ops._rows_reach_a_key(8, 8, False, 2, 8)        # rows past the keys' window
    assert fa_ops._rows_reach_a_key(8, 8, False, None, 100)


def _kernel_algorithm(q, k, v, *, causal, window, q_offset, bq=64, bk=64):
    """A float32 emulation of ``flash_attention.cu``'s schedule: blocks of
    ``bq`` query rows, each streaming only the ``bk``-key blocks that reach
    one of its rows (from the window's lower bound rounded down to a block,
    to the causal bound), with the kernel's online softmax and masks."""
    b, s, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    out = torch.empty((b, s, h, hd))
    for bi in range(b):
        for hi in range(h):
            qs = q[bi, :, hi].float() * (1.0 / np.sqrt(hd))
            ks, vs = k[bi, :, hi // group].float(), v[bi, :, hi // group].float()
            for q0 in range(0, s, bq):
                rows = torch.arange(q0, min(q0 + bq, s))
                pos = q_offset + rows
                lo = max(int(pos[0]) - window + 1, 0) if window is not None else 0
                hi_ = min(int(pos[-1]) + 1, skv) if causal else skv
                m = torch.full((len(rows),), -1e30)
                l = torch.zeros(len(rows))
                acc = torch.zeros((len(rows), hd))
                for kv0 in range(lo // bk * bk, hi_, bk):
                    kpos = torch.arange(kv0, min(kv0 + bk, skv))
                    sc = qs[rows] @ ks[kpos].T
                    ok = torch.ones_like(sc, dtype=torch.bool)
                    if causal:
                        ok &= kpos[None] <= pos[:, None]
                    if window is not None:
                        ok &= pos[:, None] - kpos[None] < window
                    sc = torch.where(ok, sc, -1e30)
                    m_new = torch.maximum(m, sc.amax(1))
                    p = torch.exp(sc - m_new[:, None])
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None] + p @ vs[kpos]
                    m = m_new
                out[bi, rows, hi] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("b,s,skv,h,hkv,hd,causal,window,q_offset", [
    *[(*c, c[2] - c[1]) for c in CASES],
    (1, 130, 300, 2, 1, 32, False, 40, 170),   # bidirectional window, blocks skipped on both sides
    (1, 70, 200, 2, 2, 32, True, 50, 130),     # causal window past the first key blocks
])
def test_kernel_algorithm_matches_plain_version(b, s, skv, h, hkv, hd, causal, window, q_offset):
    """The kernel's block schedule (64-row query blocks, 64-key blocks, key
    blocks wholly outside every row's mask skipped) gives the plain
    version's result where every row has a key."""
    q, k, v = map(torch.from_numpy, _mk(b, s, skv, h, hkv, hd, seed=skv))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert fa_ops._rows_reach_a_key(s, skv, causal, window, q_offset)
    np.testing.assert_allclose(np_(_kernel_algorithm(q, k, v, **kw)), np_(attention_ref(q, k, v, **kw)),
                               atol=ATOL, rtol=RTOL)
