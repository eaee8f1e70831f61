"""Kernel B8's three launches timed alone on the card.

At mamba2-2.7b's prefill widths (l 512, h 80, p 64, g 1, n 128, chunk
256, fp32) and b = 1, 2, 4, 8: each launch of ``csrc/ssd_fused.cu``
through its C entry point (median of 10 CUDA-event timings, the L2
flushed; the state pass also without the flush), then the whole
``ssd_fused`` call, its error against ``ssd_fused_ref`` checked as
``chip_smoke.py`` does.  Run from the repository root on a machine with
an NVIDIA GPU:

    python3 scripts/ssd_launch_times.py
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import cuda_lib, ssd  # noqa: E402

L, H, P, G, N, Q = 512, 80, 64, 1, 128, 256


def main() -> int:
    print(cs.smi_line(), flush=True)
    lib = cuda_lib.library("ssd_fused")
    flush = torch.empty(25_000_000, dtype=torch.float32, device="cuda")
    no_flush = torch.empty(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for b in (1, 2, 4, 8):
        (xd, ad, B, C), _ = cs.ssd_inputs(torch, np, b, L, H, P, G, N, "float32", seed=11)
        cum = torch.empty((b, H, L), device="cuda")
        states = torch.empty((b, H, L // Q, P, N), device="cuda")
        entering = torch.empty_like(states)
        y = torch.empty_like(xd)
        fstate = torch.empty((b, H, P, N), device="cuda")

        def chunk_state():
            return lib.repro_ssd_chunk_state(
                xd.data_ptr(), ad.data_ptr(), B.data_ptr(), cum.data_ptr(),
                states.data_ptr(), b, L, H, P, G, N, Q, 0, stream)

        def state_pass():
            return lib.repro_ssd_state_pass(
                states.data_ptr(), entering.data_ptr(), cum.data_ptr(), None,
                fstate.data_ptr(), b, L, H, P, N, Q, 0, stream)

        def chunk_output():
            return lib.repro_ssd_chunk_output(
                xd.data_ptr(), B.data_ptr(), C.data_ptr(), cum.data_ptr(),
                entering.data_ptr(), 0, y.data_ptr(), b, L, H, P, G, N, Q, 0, stream)

        for launch in (chunk_state, state_pass, chunk_output):
            if launch():
                raise RuntimeError(f"{launch.__name__} was refused")
        torch.cuda.synchronize()
        times = {f.__name__: cs.time_ms(torch, f, flush)
                 for f in (chunk_state, state_pass, chunk_output)}
        call = cs.time_ms(torch, lambda: ssd.ssd_fused(xd, ad, B, C, chunk=Q), flush)
        print(f"b={b}: chunk_state {times['chunk_state']:.4f} state_pass "
              f"{times['state_pass']:.4f} (no flush "
              f"{cs.time_ms(torch, state_pass, no_flush):.4f}) chunk_output "
              f"{times['chunk_output']:.4f} all {call:.4f} ms", flush=True)
        got = ssd.ssd_fused(xd, ad, B, C, chunk=Q)
        want = ssd.ssd_fused_ref(xd, ad, B, C, chunk=Q)
        print("  err", cs.ssd_violation(torch, got[0], want[0], "float32"),
              cs.ssd_violation(torch, got[1], want[1], "float32"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
