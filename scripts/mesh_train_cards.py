"""mamba2-2.7b trained on a (2, 2) (data, model) mesh of four cards.

First a 2-layer full-width cut: one train step born sharded on the four
cards against the same cut unsharded on card 0 (loss and grad norm within
1e-5 relative).  Then the full model (64 layers, d_model 2560), born
sharded on the four cards (no card ever holds the whole model; the
moments ZeRO-1 over the data axis), trained 3 steps of (2, 512) tokens
(remat "full"): each step's ms, tokens/s and the peak GB of each card.
Raises ``ValueError`` on a machine with fewer than four visible cards.
Run from the repository root:

    python3 scripts/mesh_train_cards.py
"""
import dataclasses
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compat import make_mesh  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import gather as gather_k  # noqa: E402
from repro_torch.kernels import ssd as ssd_k  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import (TrainConfig, TrainLoopConfig,  # noqa: E402
                               init_train_state, make_train_step, train_loop)

ARCH = "mamba2-2.7b"
SHAPE = (2, 2)
RTOL = 1e-5


def cut_check(mesh, tcfg) -> None:
    """One step of the 2-layer cut on the mesh and on card 0."""
    cfg = dataclasses.replace(configs.get_config(ARCH), n_layers=cs.LM_CHECK_LAYERS)
    batch = cs.train_batch(np, cfg, cs.TRAIN_BATCH)
    step = make_train_step(cfg, tcfg)
    one, m1 = step(init_train_state(M.make_generator(cs.LM_SEED, "cuda:0"), cfg,
                                    tcfg), batch)
    del one
    placed, m2 = step(init_train_state(M.make_generator(cs.LM_SEED, "cuda:0"),
                                       cfg, tcfg, mesh=mesh), batch)
    del placed
    for key in ("loss", "grad_norm"):
        rel = abs(float(m2[key]) - float(m1[key])) / abs(float(m1[key]))
        if not rel <= RTOL:
            raise AssertionError(f"{key} on the cards {float(m2[key])} vs card 0 "
                                 f"{float(m1[key])} ({rel:.2e} > {RTOL})")
        cs.phase("mesh-cards", f"{cfg.name} {cfg.n_layers} layers: {key} on "
                 f"{SHAPE} {float(m2[key]):.6f} vs card 0 {float(m1[key]):.6f} "
                 f"(rel {rel:.2e} <= {RTOL})")


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(SHAPE, ("data", "model"))      # four distinct cards
    print(cs.smi_line(), flush=True)
    cuda_lib.build_all(["ssd_fused", "ssd_bwd", "embedding_gather"])
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=cs.TRAIN_LR), remat=cs.TRAIN_REMAT)
    cut_check(mesh, tcfg)
    cfg = configs.get_config(ARCH)
    for dev in mesh.devices.flat:
        torch.cuda.reset_peak_memory_stats(dev)
    ssd_k.KERNEL_LAUNCHES = ssd_k.BWD_LAUNCHES = 0
    gather_k.SHARD_LAUNCHES = gather_k.SHARD_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    state, hist = train_loop(
        cfg, tcfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=cs.TRAIN_SEQ,
                              global_batch=cs.TRAIN_BATCH, seed=cs.LM_SEED),
        TrainLoopConfig(total_steps=cs.TRAIN_STEPS, log_every=1, seed=cs.LM_SEED),
        mesh=mesh, log=lambda s: print(s, flush=True))
    steady = [h["wall_s"] for h in hist[1:]]
    gb = [torch.cuda.max_memory_allocated(d) / 1e9 for d in mesh.devices.flat]
    cs.phase("mesh-cards", f"{cfg.name} ({cfg.n_layers} layers) on {SHAPE} of "
             f"{len(gb)} cards: step {statistics.median(steady) * 1e3:.1f} ms, "
             f"{cs.TRAIN_BATCH * cs.TRAIN_SEQ / statistics.median(steady):.1f} "
             f"tokens/s (median of steps 1+), peak GB a card "
             f"{[round(g, 2) for g in gb]}; launches B8 {ssd_k.KERNEL_LAUNCHES}, "
             f"B8 bwd {ssd_k.BWD_LAUNCHES}, B9 shard {gather_k.SHARD_LAUNCHES}, "
             f"B9 shard bwd {gather_k.SHARD_BWD_LAUNCHES}; "
             f"{time.perf_counter() - t0:.1f} s")
    del state
    return 0


if __name__ == "__main__":
    sys.exit(main())
