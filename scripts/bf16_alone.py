"""``chip_smoke.py``'s bf16 phase (phase 18, ``bf16``) alone on the card.

The bf16 forms of kernels B8 and B9 against their contracts, then (without
``--compare-only``) the served bf16 model, the bf16 train step and its
checks, the (1, 4) mesh step, and each form timed.  Prints the kernels
line's bf16 records as one JSON line.  Builds only the kernels the phase
runs (B8 and its backward, B9).  Run from the repository root on a machine
with an NVIDIA GPU:

    python3 scripts/bf16_alone.py [--compare-only]
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
from repro_torch import configs, serve  # noqa: E402
from repro_torch.compat import make_mesh  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import gather as gather_k  # noqa: E402
from repro_torch.kernels import ssd as ssd_k  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_alone: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    t0 = time.perf_counter()
    for b in cuda_lib.build_all(["ssd_fused", "ssd_bwd", "embedding_gather"]):
        cs.phase("build", f"{b.name} in {b.seconds:.1f} s")
        for ln in b.log.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln.lower():
                cs.phase("build", f"  {ln.strip()}")
    if "--compare-only" in sys.argv[1:]:
        cfg = cs.lm_config(configs)
        hybrid = cs.lm_family_config(configs, cs.LM_FAMILY_ARCHS[0])
        cs.compare_bf16_ssd(torch, np, ssd_k, cfg, hybrid)
        cs.compare_bf16_ssd_bwd(torch, np, ssd_k, cs.train_config(configs), hybrid)
        cs.compare_bf16_gather(torch, np, gather_k, cfg)
        cs.phase("bf16", f"compare done in {time.perf_counter() - t0:.1f} s")
        return 0
    flush = torch.empty(2 * 50 * 1000 * 1000 // 4, dtype=torch.float32,
                        device=cs.DEVICE)
    records = cs.run_bf16(torch, np, configs, M, serve, ssm_mod, sharding,
                          make_mesh, ssd_k, gather_k, flush)
    cs.phase("bf16", f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(records), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
