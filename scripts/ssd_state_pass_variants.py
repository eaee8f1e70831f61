"""Three forms of kernel B8's state pass timed on the card.

``scripts/ssd_state_pass_variants.cu`` holds them: A rewrites the chunk
states in place with 64-bit index math (the first form), B writes the
entering states to their own buffer on a (b h, p n / 256) grid (the
committed form), C rewrites in place four entries a thread.  Each is
timed (median of 10 CUDA-event timings, the L2 flushed) at mamba2-2.7b's
state shapes, b = 1, 4, 8.  Run from the repository root on a machine
with an NVIDIA GPU:

    python3 scripts/ssd_state_pass_variants.py
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402

H, P, N, L, Q = 80, 64, 128, 512, 256


def build() -> ctypes.CDLL:
    (ROOT / "build").mkdir(exist_ok=True)
    out = ROOT / "build/libssd_state_pass_variants.so"
    proc = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out),
         str(ROOT / "scripts/ssd_state_pass_variants.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.run_a.argtypes = [p, p, p, i64, i64, i, i, i, i, p]
    lib.run_b.argtypes = [p, p, p, p, i64, i64, i, i, i, p]
    lib.run_c.argtypes = [p, p, p, i64, i64, i, i, i, p]
    return lib


def main() -> int:
    print(cs.smi_line(), flush=True)
    lib = build()
    flush = torch.empty(25_000_000, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for b in (1, 4, 8):
        states = torch.randn((b, H, L // Q, P, N), device="cuda")
        entering = torch.empty_like(states)
        cum = -torch.rand((b, H, L), device="cuda")
        fstate = torch.empty((b, H, P, N), device="cuda")
        ptr = (states.data_ptr(), cum.data_ptr(), fstate.data_ptr())
        forms = {
            "A": lambda: lib.run_a(*ptr, b, L, H, P, N, Q, stream),
            "B": lambda: lib.run_b(states.data_ptr(), entering.data_ptr(), *ptr[1:],
                                   b * H, L, P * N, Q, L // Q, stream),
            "C": lambda: lib.run_c(*ptr, b * H, L, P * N, Q, L // Q, stream),
        }
        print(f"b={b}: " + "  ".join(
            f"{k} {cs.time_ms(torch, f, flush):.4f}" for k, f in forms.items())
            + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
