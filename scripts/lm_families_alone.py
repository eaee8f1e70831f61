"""``chip_smoke.py``'s families phase (phase 13, ``lm-families``) alone on the
card, after B8's compare cases (phase 3's, hymba's shapes among them).

hymba-1.5b, seamless-m4t-medium and llama-3.2-vision-11b at full width and
depth, one at a time, nothing else resident: each served by the batcher
(8 requests of 512 tokens) and the engine ((4, 512), with stub
``ctx_embeds`` for the enc-dec and vision LMs), its card-vs-CPU check
(hymba's also on a 2560-token prompt that wraps its ring), a profiled
prefill and decode step and its peak memory; B8 timed at hymba's prefill
shapes.  Prints the phase's B8 / B9 launches and B8's hymba readings as
one JSON line.  Builds only the two kernels the phase runs (B8, B9).  Run
from the repository root on a machine with an NVIDIA GPU (~2 min):

    python3 scripts/lm_families_alone.py
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
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import gather as gather_k  # noqa: E402
from repro_torch.kernels import ssd as ssd_k  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    t0 = time.perf_counter()
    cuda_lib.build_all(["ssd_fused", "embedding_gather"])
    errs = cs.compare_ssd(torch, np, ssd_k, cs.lm_config(configs),
                          cs.lm_family_config(configs, cs.LM_FAMILY_ARCHS[0]))
    flush = torch.empty(2 * 50 * 1000 * 1000 // 4, dtype=torch.float32,
                        device="cuda")
    fam = cs.lm_families_path(torch, np, configs, M, serve, ssd_k, gather_k,
                              flush)
    cs.phase("lm-families", f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"compare_err": errs, "launches": {
        k: fam[k] for k in ("ssd_fused", "embedding_gather")},
        "hymba_b8": fam["hymba_b8"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
