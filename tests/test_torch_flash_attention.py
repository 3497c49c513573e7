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

The two CUDA kernels' schedules are emulated in float32 on the CPU: the
float32 kernel's (64-row, 64-key blocks) against the plain version at the
float32 tolerance, and the bfloat16 tensor-core kernel's (128-row blocks in
two 64-row halves, 128-key blocks, masks only where the kernel masks, P
rounded to bf16) against the JAX oracle on bf16 inputs at the card's
bfloat16 tolerance, atol 1e-2, rtol 1.6e-2.
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


def _tensor_core_algorithm(q, k, v, *, causal, window, q_offset, bq=128, bk=128, wg_rows=64):
    """A float32 emulation of the bfloat16 kernel of ``flash_attention.cu``
    (the tensor-core schedule): blocks of ``bq`` query rows in two halves of
    ``wg_rows`` (one per consumer warpgroup), ``bk``-key blocks from the
    window's lower bound rounded down to a block to the causal bound, keys
    and values past Skv zero (as the TMA fills them). Raw bf16 q.k in
    float32, scaled inside exp2 as s * scale*log2e - m * scale*log2e; the
    element masks only in the blocks the kernel masks (crossing Skv, the
    causal diagonal or a window edge for the half's rows), no mask
    arithmetic elsewhere; l from the unrounded p, P rounded to bf16 before
    P V, float32 accumulators; out = acc * (1 / max(l, 1e-30)) in bf16.
    Returns the output and the counts of (half, block) pairs run with and
    without masks and of key blocks skipped."""
    b, s, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    c = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32) * torch.tensor(1.4426950408889634, dtype=torch.float32)
    pad = -skv % bk
    kz = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vz = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    n_kv_blocks = (skv + pad) // bk
    out = torch.empty((b, s, h, hd))
    counts = {"masked": 0, "unmasked": 0, "skipped": 0}
    for bi in range(b):
        for hi in range(h):
            qs = q[bi, :, hi].float()
            ks, vs = kz[bi, :, hi // group], vz[bi, :, hi // group]
            for q0 in range(0, s, bq):
                n_q = min(bq, s - q0)
                lo = max(q_offset + q0 - window + 1, 0) // bk * bk if window is not None else 0
                hi_ = min(q_offset + q0 + n_q, skv) if causal else skv
                blocks = range(lo, hi_, bk)
                counts["skipped"] += n_kv_blocks - len(blocks)
                for w0 in range(q0, q0 + n_q, wg_rows):
                    rows = torch.arange(w0, min(w0 + wg_rows, s))
                    pos = q_offset + rows
                    first, last = q_offset + w0, q_offset + w0 + wg_rows - 1
                    m = torch.full((len(rows),), -1e30)
                    l = torch.zeros(len(rows))
                    acc = torch.zeros((len(rows), hd))
                    for kv0 in blocks:
                        kpos = torch.arange(kv0, kv0 + bk)
                        sc = qs[rows] @ ks[kpos].T
                        if (kv0 + bk > skv or (causal and kv0 + bk - 1 > first)
                                or (window is not None and last - kv0 >= window)):
                            counts["masked"] += 1
                            ok = (kpos < skv)[None].expand_as(sc)
                            if causal:
                                ok = ok & (kpos[None] <= pos[:, None])
                            if window is not None:
                                ok = ok & (pos[:, None] - kpos[None] < window)
                            sc = torch.where(ok, sc, -1e30)
                        else:
                            counts["unmasked"] += 1
                        m_new = torch.maximum(m, sc.amax(1))
                        corr = torch.exp2((m - m_new) * c)
                        p = torch.exp2(sc * c - (m_new * c)[:, None])
                        l = l * corr + p.sum(1)
                        acc = acc * corr[:, None] + p.to(torch.bfloat16).float() @ vs[kpos]
                        m = m_new
                    out[bi, rows, hi] = acc * (1.0 / torch.clamp(l, min=1e-30))[:, None]
    return out.to(torch.bfloat16), counts


@pytest.mark.parametrize("b,s,skv,h,hkv,hd,causal,window", [
    *CASES,
    (1, 1536, 1536, 2, 1, 128, True, 1024),  # a Gemma3-style 1024-key window at hd 128: blocks skipped
])
def test_tensor_core_algorithm_matches_jax_chunked_attention(b, s, skv, h, hkv, hd, causal, window):
    """The bfloat16 kernel's numerics (P rounded to bf16, raw q.k scaled in
    exp2, masks only where the kernel masks) against the JAX oracle on bf16
    inputs, at the card's bfloat16 tolerance (atol 1e-2, rtol 1.6e-2: one
    bf16 step is up to 2^-7 relative, and rounding P adds up to another)."""
    q, k, v = _mk(b, s, skv, h, hkv, hd, seed=s + hd)
    off = skv - s
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax.jit(lambda q, k, v: j_chunked(q, k, v, causal=causal, window=window, q_offset=off))(
        jq, jk, jv).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in (jq, jk, jv))
    got, counts = _tensor_core_algorithm(tq, tk, tv, causal=causal, window=window, q_offset=off)
    np.testing.assert_allclose(np_(got.float()), want, atol=1e-2, rtol=1.6e-2)
    if window == 1024:  # masked, unmasked and skipped blocks are all reached
        assert min(counts.values()) > 0, counts
