"""``chip_smoke.py``'s MoE LM phase (phase 12, ``lm-moe``) alone on the card.

deepseek-moe-16b at full width and depth, nothing else resident: the
plain and the fused engine on (4, 512) prompts, B1 timed at the first
MoE layer's prefill and decode routing, the 2-layer card-vs-CPU check
with the card's combine on B1, a prefill and a decode step under
``torch.profiler`` on each path, the peak memory; then the ``kernels``
records of the two B1 shapes as one JSON line.  Builds only the two
kernels the phase runs (B1, B9).  Run from the repository root on a
machine with an NVIDIA GPU (~30 s):

    python3 scripts/lm_moe_alone.py
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
from repro_torch.kernels import cuda_lib, ops, sell_core  # noqa: E402
from repro_torch.kernels import gather as gather_k  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.service import KernelRegistry, KernelService  # noqa: E402


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    print(cs.smi_line(), flush=True)
    t0 = time.perf_counter()
    cuda_lib.build_all(["spmm_sell", "embedding_gather"])
    flush = torch.empty(2 * 50 * 1000 * 1000 // 4, dtype=torch.float32,
                        device="cuda")
    records, _ = cs.run_lm_moe(torch, np, configs, M, serve, moe, sell_core,
                               gather_k, ops, KernelRegistry, KernelService,
                               flush)
    cs.phase("lm-moe", f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
