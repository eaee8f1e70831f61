"""``chip_smoke.py``'s dry-run phase (phase 20, ``dryrun``) alone on the card.

(a) mamba2-2.7b's train step at (2, 512) and llama-3.2-3b's (4, 512)
prefill run first on fake tensors on one placeholder host device
(``repro_torch.launch.dryrun``), then on the card: argument bytes, aten
FLOPs and the peak device memory held to the prediction; (b) qwen3-14b's
decode_32k cell on the single-pod mesh's 256 placeholders in a subprocess
started after the build, before (a), its record printed beside the card's
memory.  Prints
the phase's readings as one JSON line.  Builds only the kernels the phase
runs (B8 and its backward, B9).  Run from the repository root on a machine
with an NVIDIA GPU:

    python3 scripts/dryrun_alone.py
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import gather as gather_k  # noqa: E402
from repro_torch.kernels import ssd as ssd_k  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as specs_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("dryrun_alone: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    t0 = time.perf_counter()
    cuda_lib.build_all(["ssd_fused", "ssd_bwd", "embedding_gather"])
    cell = cs.start_dryrun_cell()
    dr = cs.dryrun_path(torch, np, configs, M, specs_mod, dryrun, ssd_k,
                        gather_k, cell)
    cs.phase("dryrun", f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(dr), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
