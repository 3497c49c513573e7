#!/usr/bin/env python3
"""Quick card check of the port's attention kernels, for work on
``src/repro_torch/kernels/flash_attention/flash_attention.cu``: build the
kernel library, print ptxas's registers and spill bytes for the attention
instances, then hold both kernels (bfloat16 on the tensor cores, float32 on
the CUDA cores) against the plain version on ``chip_smoke.py``'s sweep and
a bidirectional case at hd 128, and time them at the Qwen3-0.6B prefill
shape beside ``scaled_dot_product_attention``.

    python3 scripts/attention_probe.py

Run from the root of a checkout on a machine with one NVIDIA H100. Before
it launches anything it refuses (exit 3) unless every warp-specialised
bf16 instance starts at 168 registers, the count its ``setmaxnreg`` split
(consumers 240, producer 24, at 384 threads) assumes: a
``setmaxnreg.inc`` that finds no free registers waits forever. Exit 1 if a
case disagrees, 2 without a card. It takes ~20 s of command time;
``chip_smoke.py`` is the full check.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _lib
    from repro_torch.kernels.cost import attention_cost
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    build = _lib.build_library()
    print(f"build {build.seconds:.2f} s", flush=True)
    entries = {n: e for n, e in cs.ptxas_entries(build.log).items() if "attention" in n}
    for name, e in entries.items():
        print(name, e)
    tc = [e for n, e in entries.items() if "attention_tc_kernel" in n]
    if len(tc) != 3 or any(e.get("registers") != 168 for e in tc):
        print("attention_probe: a bf16 instance does not start at 168 registers; not launching")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, s, skv, h, hkv, hd, dtype):
        return [torch.randn(shape, device=dev, generator=gen).to(dtype)
                for shape in ((b, s, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd))]

    bad_cases = 0
    for b, s, skv, h, hkv, hd, causal, window in [*cs.FLASH_CASES, (1, 256, 256, 2, 2, 128, False, None)]:
        for dtype, tol in ((torch.bfloat16, cs.FLASH_BF16_TOL), (torch.float32, cs.FLASH_F32_TOL)):
            q, k, v = qkv(b, s, skv, h, hkv, hd, dtype)
            kw = dict(causal=causal, window=window, q_offset=skv - s)
            got = fa.launch(q, k, v, **kw)
            torch.cuda.synchronize()
            want = attention_ref(q, k, v, **kw)
            err, bad = cs.allclose_report(got.float(), want.float(), *tol)
            print(f"{(b, s, skv, h, hkv, hd, causal, window)} {str(dtype)[6:]}: max_abs_err {err:.3e}, outside "
                  f"{bad} of {got.numel()}, bitwise equal share {float((got == want).float().mean()):.4f}", flush=True)
            bad_cases += bool(bad) or not bool(torch.isfinite(got).all())

    q, k, v = qkv(4, 4096, 4096, 16, 8, 128, torch.bfloat16)
    out = fa.launch(q, k, v)
    err, bad = cs.allclose_report(out.float(), attention_ref(q, k, v).float(), *cs.FLASH_BF16_TOL)
    same = torch.equal(fa.launch(q, k, v), out)
    print(f"prefill shape bf16: max_abs_err {err:.3e}, outside {bad}, two launches bitwise equal {same}")
    bad_cases += bool(bad) or not same
    flops, _ = attention_cost(q, k, v, causal=True)
    ms = cs.cuda_ms(lambda: fa.launch(q, k, v), 20, "bf16 kernel")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = cs.cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), 20,
                        "scaled_dot_product_attention")
    q32, k32, v32 = (x.float() for x in (q, k, v))
    f32_ms = cs.cuda_ms(lambda: fa.launch(q32, k32, v32), 3, "float32 kernel")
    print(f"prefill shape ({card}): bf16 kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
          f"scaled_dot_product_attention {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), "
          f"float32 kernel {f32_ms:.4f} ms")
    return 1 if bad_cases else 0


if __name__ == "__main__":
    sys.exit(main())
