"""Batched serving CLI: continuous batcher over the generation engine —
port of ``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b --full \\
      --prompt-len 512 --new-tokens 16

runs on the card (random init at the published widths, directly on the
card: 14.4 GB of fp32 weights for llama-3.2-3b, 11.3 GB for mamba2-2.7b,
65.5 GB for deepseek-moe-16b, 6.6 GB for hymba-1.5b, 47.9 GB for
llama-3.2-vision-11b, 3.9 GB for seamless-m4t-medium); ``--device cpu``
without ``--full`` runs the reduced config on the CPU through the kernels'
plain versions.  Every arch of the registry is served: families
``"dense"`` (llama3.2-3b, qwen2-1.5b, qwen3-14b, minicpm-2b), ``"moe"``
(mixtral-8x7b, deepseek-moe-16b; the batcher runs their MoE combines on
the dense path, as the reference's does), ``"ssm"`` (mamba2-2.7b),
``"hybrid"`` (hymba-1.5b), ``"vlm"`` (llama-3.2-vision-11b) and
``"audio"`` (seamless-m4t-medium); as in the reference, the batcher hands
the last two no ``ctx_embeds``, so their requests decode against the
caches' zero context.  mixtral-8x7b ``--full`` does not fit one card: its
46.7 B parameters are 186.8 GB in fp32 against 80 GB.  ``--mesh single``
/ ``multi`` serves on the reference's production mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`: (16, 16) or (2, 16,
16) distinct cards, ``ValueError`` on a machine with fewer), the
parameters born sharded by the partition rules (every arch; the vision
and enc-dec ones against the zero context, as without a mesh).
``scripts/mesh_serve_cards.py``
serves mixtral-8x7b on the cards a machine has.  The batcher's KV caches
share one length across slots, as the reference's: prompts of one length
serve correctly.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels.execspec import resolve_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.obs import Stopwatch
from repro_torch.serve import Batcher, GenerationConfig, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCHS, default="mamba2-2.7b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none",
                    help="production mesh to shard over (needs the device count)")
    ap.add_argument("--device", default="cuda",
                    help="where to serve: cuda (default) or cpu")
    args = ap.parse_args(argv)
    mesh = (None if args.mesh == "none"
            else make_production_mesh(multi_pod=(args.mesh == "multi")))
    dev = resolve_device(args.device) if mesh is None else mesh.devices.flat[0]

    cfg = configs.get_config(args.arch) if args.full else configs.reduced_config(args.arch)
    # on a mesh the parameters are born sharded by the partition rules
    params = M.init_params(M.make_generator(args.seed, dev), cfg, mesh=mesh)
    gcfg = GenerationConfig(cache_len=args.cache_len)
    batcher = Batcher(cfg, params, n_slots=args.slots, gcfg=gcfg, mesh=mesh)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, (args.prompt_len,)).astype(np.int32)
        batcher.submit(Request(rid=rid, prompt=prompt, max_new_tokens=args.new_tokens))
    with Stopwatch() as sw:
        done = batcher.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dt = sw.elapsed_s
    total_tokens = sum(len(r.generated) for r in done)
    print(f"[serve] {cfg.name} on {dev}: {len(done)} requests, {total_tokens} "
          f"tokens in {dt:.2f}s ({total_tokens / dt:.1f} tok/s incl. first-use kernel builds)")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.generated[:8]}...")


if __name__ == "__main__":
    main()
