"""``chip_smoke.py``'s train phase (phase 14, ``train``) alone on the card.

B8's and B9's backward kernels against their plain versions, the 2-layer
full-width card-vs-CPU train step, mamba2-2.7b at full width trained 3
steps through the port's CLI with one more step profiled, the resume check
at the reduced config, and both backward kernels timed; prints the kernels
line's records of the phase as one JSON line.  Builds only the kernels the
phase runs (B8 forward and backward, B9).  Run from the repository root on
a machine with an NVIDIA GPU (~2 min):

    python3 scripts/train_alone.py
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
from repro_torch.models import model as M  # noqa: E402


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    t0 = time.perf_counter()
    cuda_lib.build_all(["ssd_fused", "ssd_bwd", "embedding_gather"])
    cfg = cs.train_config(configs)
    errs = {"ssd": cs.compare_ssd_bwd(torch, np, ssd_k, cfg, cs.lm_family_config(
        configs, cs.LM_FAMILY_ARCHS[0])),
        "gather": cs.compare_gather_bwd(torch, np, gather_k, cfg)}
    cs.train_check(torch, np, M, ssd_k, gather_k, cfg)
    tm = cs.train_path(torch, np, configs, M, ssd_k, gather_k)
    cs.train_resume(torch, configs)
    flush = torch.empty(2 * 50 * 1000 * 1000 // 4, dtype=torch.float32,
                        device="cuda")
    records = cs.time_train_kernels(torch, np, ssd_k, gather_k, tm, errs, flush)
    cs.phase("train", f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records, "launches": tm["launches"],
                      "tokens_per_s": tm["tokens_per_s"],
                      "peak_gb": tm["peak_gb"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
