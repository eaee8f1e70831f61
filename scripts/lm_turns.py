"""The LM phase of two checkouts of this repository, in turns on one card.

Runs ``chip_smoke.py``'s LM phase (``lm_path``: mamba2-2.7b at full width
and depth, 8 prompts of 512 tokens through ``Batcher(n_slots=4)``, one
``ServeEngine.generate`` on (4, 512); then ``profile_lm``: one b = 1
prefill and one b = 4 decode step under ``torch.profiler``; then B8's
timing lines of ``time_lm`` at b = 1 and 4) of each
checkout in its own process, in the order old, new, new, old, each
building its own B8 and B9 into its own ``build/``.  Prints the card's
name and power limit, then each run's ``[lm]``, ``[profile]`` and B8
``[timing]`` lines under a header naming the checkout.  Run
from the repository root on a machine with an NVIDIA GPU, the older
commit unpacked with ``git archive`` into a git-ignored directory:

    python3 scripts/lm_turns.py build/parent .
"""
import subprocess
import sys
from pathlib import Path

CHILD = """
import inspect
import sys
sys.path[:0] = ["src", "."]
import numpy as np
import torch
import chip_smoke as cs
from repro_torch import configs, serve
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import gather as gather_k
from repro_torch.kernels import ssd as ssd_k
from repro_torch.models import model as M
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cuda_lib.build_all(["ssd_fused", "embedding_gather"])
lm = cs.lm_path(torch, np, configs, M, serve, ssd_k, gather_k)
cs.profile_lm(torch, M, lm)
flush = torch.empty(25_000_000, dtype=torch.float32, device="cuda")
by_path = ({"b9_by_path": {"lm": lm["launches"]["embedding_gather"]}}
           if "b9_by_path" in inspect.signature(cs.time_lm).parameters
           else {})
cs.time_lm(torch, np, ssd_k, gather_k, lm, 0.0, flush=flush, **by_path)
"""


def main() -> int:
    old, new = (Path(a).resolve() for a in sys.argv[1:3])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    rc = 0
    for name, root in (("old", old), ("new", new), ("new", new), ("old", old)):
        print(f"=== {name}: {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                              capture_output=True, text=True, timeout=900)
        for line in proc.stdout.splitlines():
            if line.startswith(("[lm]", "[profile]", "[timing] B8")):
                print(line, flush=True)
        if proc.returncode:
            print(proc.stderr[-3000:], flush=True)
            rc = proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
