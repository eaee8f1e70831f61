"""``chip_smoke.py``'s mesh-train phase (phase 16, ``mesh-train``) alone on
the card.

B9's shard backward against its plain version; one train step of 2-layer
full-width cuts of mamba2-2.7b, llama-3.2-3b and deepseek-moe-16b on
(data, model) meshes naming the card four times against the unsharded
port; mamba2 served on a mesh; mamba2-2.7b at full width and depth trained
3 steps on (1, 4); a resume on a mesh; the shard backward timed.  Prints
the phase's kernel record and readings as one JSON line.  Builds only the
kernels the phase runs (B8 and its backward, B9).  Run from the repository
root on a machine with an NVIDIA GPU:

    python3 scripts/mesh_train_alone.py
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
        print("mesh_train_alone: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    t0 = time.perf_counter()
    cuda_lib.build_all(["ssd_fused", "ssd_bwd", "embedding_gather"])
    flush = torch.empty(2 * 50 * 1000 * 1000 // 4, dtype=torch.float32,
                        device="cuda")
    mt, rec = cs.run_mesh_train(torch, np, configs, M, serve, ssm_mod, sharding,
                                make_mesh, ssd_k, gather_k, flush)
    cs.phase("mesh-train", f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [rec], "launches": mt["launches"],
                      "step_ms": mt["step_ms"], "tokens_per_s": mt["tokens_per_s"],
                      "peak_gb": mt["peak_gb"], "checks": mt["checks"],
                      "serve": mt["serve"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
