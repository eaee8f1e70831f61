"""End-to-end training CLI — port of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 6 \\
      --batch 2 --seq-len 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b --full \\
      --seq-len 512 --batch 2 --remat full --steps 3

Without ``--device`` it trains on the card and raises on a machine without
one (no fallback to the CPU); ``--device cpu`` without ``--full`` trains
the reduced config on the CPU through the kernels' plain versions.
``--full`` is the published widths, random init on the card from
``--seed``: mamba2-2.7b's 11.3 GB of float32 parameters with their
gradients and AdamW's moments take about 45 GB, and ``--remat full``
keeps the saved activations near a block's input a layer.  The model
trains in float32 (kernels B8 and B9 take float32 / float64).  minicpm
trains with WSD, as in the reference; the others at a constant rate.  The
vision and enc-dec families need ``ctx_embeds`` in the batch, which this
CLI does not make (the reference's neither).  ``--mesh single`` /
``multi`` trains on the reference's production mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`: (16, 16) or (2, 16,
16) distinct cards, ``ValueError`` naming the count on a machine with
fewer), the state born sharded (:func:`repro_torch.train.loop
.train_loop` with ``mesh=``; every family this CLI trains: without
``ctx_embeds`` not the vision and enc-dec ones, which
:func:`repro_torch.train.step.loss_and_grads` trains on a mesh given
them).  Prints a
``[train]`` line every 10 steps and a ``[done]`` line; :func:`main`
returns (final state, history).
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import AdamWConfig, wsd_schedule
from repro_torch.train import TrainConfig, TrainLoopConfig, train_loop

__all__ = ["main", "parse_args"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCHS, default="qwen2-1.5b")
    ap.add_argument("--full", action="store_true",
                    help="the published config (on the card)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none",
                    help="production mesh to shard over (needs the device count)")
    ap.add_argument("--device", default="cuda",
                    help="where to train: cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, log=print):
    args = parse_args(argv)
    mesh = (None if args.mesh == "none"
            else make_production_mesh(multi_pod=(args.mesh == "multi")))
    cfg = configs.get_config(args.arch) if args.full else configs.reduced_config(args.arch)
    # minicpm trains with WSD (its defining feature); the others at a constant rate
    if args.arch == "minicpm-2b":
        lr = wsd_schedule(args.lr, warmup=args.steps // 10,
                          stable=args.steps * 7 // 10, decay=args.steps // 5)
    else:
        lr = args.lr
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=lr),
        remat=None if args.remat == "none" else args.remat,
        accum_steps=args.accum,
        compress_grads=args.compress_grads,
    )
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.batch, seed=args.seed)
    lcfg = TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                           ckpt_dir=args.ckpt_dir, log_every=10, seed=args.seed)
    state, history = train_loop(cfg, tcfg, dcfg, lcfg, log=log, mesh=mesh,
                                device=args.device)
    first = sum(h["loss"] for h in history[:5]) / max(len(history[:5]), 1)
    last = sum(h["loss"] for h in history[-5:]) / max(len(history[-5:]), 1)
    where = args.device if mesh is None else f"a {mesh.shape} mesh"
    log(f"[done] arch={cfg.name} on {where} steps={len(history)} "
        f"loss {first:.4f} -> {last:.4f}")
    return state, history


if __name__ == "__main__":
    main()
