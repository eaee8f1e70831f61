"""``chip_smoke.py``'s flags phase (phase 19, ``flags``) alone on the card.

The reference's five opt-in attention and placement flags at full width:
llama-3.2-3b under ``ATTN_KV_CHUNK`` and ``ATTN_BF16_SCORES``, hymba-1.5b's
2560-token prefill under ``ATTN_KV_CHUNK``, hymba-1.5b and qwen2-1.5b on
(1, 4) under ``SEQ_SHARD_FALLBACK`` / ``KV_SEQ_SHARD``, llama-3.2-3b on
(2, 2) under ``FSDP_PARAMS`` (served and trained), each against the run
without its flag or the port unsharded.  Prints the phase's readings as
one JSON line.  Builds only the kernels the phase runs (B8 and its
backward, B9).  Run from the repository root on a machine with an NVIDIA
GPU:

    python3 scripts/flags_alone.py
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
from repro_torch.launch import specs as specs_mod  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("flags_alone: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    t0 = time.perf_counter()
    cuda_lib.build_all(["ssd_fused", "ssd_bwd", "embedding_gather"])
    fl = cs.run_flags(torch, np, configs, M, serve, make_mesh, attn_mod,
                      specs_mod, ssd_k, gather_k)
    cs.phase("flags", f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(fl), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
