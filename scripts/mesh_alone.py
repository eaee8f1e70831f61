"""``chip_smoke.py``'s mesh phase (phase 15, ``mesh``) alone on the card.

B9's vocab-shard form against its plain version, the dense and MoE
families over (data, model) meshes naming the card several times, each
held against the unsharded port, and the shard form timed; prints the
phase's kernel record and runs as one JSON line.  Builds only the kernels
the phase runs (B1, B9).  Run from the repository root on a machine with
an NVIDIA GPU (~1.5 min on one H100, the build included):

    python3 scripts/mesh_alone.py
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
from repro_torch.kernels import cuda_lib, sell_core  # noqa: E402
from repro_torch.kernels import gather as gather_k  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe, sharding  # noqa: E402
from repro_torch.service import KernelRegistry, KernelService  # noqa: E402


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    t0 = time.perf_counter()
    cuda_lib.build_all(["spmm_sell", "embedding_gather"])
    err = cs.compare_gather_shard(torch, np, gather_k)
    mp = cs.mesh_path(torch, np, configs, M, serve, moe, sell_core, gather_k,
                      KernelRegistry, KernelService, make_mesh, sharding)
    flush = torch.empty(2 * 50 * 1000 * 1000 // 4, dtype=torch.float32,
                        device="cuda")
    rec = cs.time_gather_shard(torch, np, gather_k, flush, mp["b9_shard"], err)
    cs.phase("mesh", f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [rec], "b1_launches": mp["b1"],
                      "runs": mp["runs"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
