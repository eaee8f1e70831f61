"""``chip_smoke.py``'s mesh-families phase (phase 17, ``mesh-families``)
alone on the card.

hymba-1.5b, seamless-m4t-medium and llama-3.2-vision-11b at full width,
each unsharded, then born sharded on (1, 4) and (2, 2) meshes naming the
card four times (vision's (2, 2) at 20 layers), held to the unsharded
logits and tokens; then the families' train-step checks.  Prints the
phase's readings as one JSON line.  Builds only the kernels the phase
runs (B8 and its backward, B9).  Run from the repository root on a machine
with an NVIDIA GPU:

    python3 scripts/mesh_families_alone.py
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
        print("mesh_families_alone: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    t0 = time.perf_counter()
    cuda_lib.build_all(["ssd_fused", "ssd_bwd", "embedding_gather"])
    mf = cs.mesh_families_path(torch, np, configs, M, serve, sharding, make_mesh,
                               ssm_mod, ssd_k, gather_k)
    cs.phase("mesh-families", f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(mf), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
