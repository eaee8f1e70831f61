"""mixtral-8x7b at its published widths and depth served over the cards of
one machine: a (data, model) mesh from the elastic plan of the visible
device count, the parameters born sharded by the partition rules (186.8 GB
of fp32 weights: no card holds them whole), 8 requests of 512 tokens and
16 new each through ``Batcher(n_slots=4)``.

First it checks a 2-layer cut at full width: the same seed's parameters
born sharded on the mesh against the unsharded model on card 0, greedy
tokens of (4, 512) prompts equal wherever the unsharded top-2 margin
exceeds 1e-4 x max|logit| (``chip_smoke.py``'s rule).  It prints
tokens/s, prefill and decode times and ``torch.cuda.max_memory_allocated``
per card, then one JSON line.  It raises on a machine with fewer than four
visible cards (no fallback).  Run from the repository root (~1 min on four
H100s):

    python3 scripts/mesh_serve_cards.py
"""
import dataclasses
import gc
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
from repro_torch.launch.mesh import make_mesh_from_plan  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime.elastic import plan_mesh  # noqa: E402

ARCH = "mixtral-8x7b"
CHECK_LAYERS = 2
MIN_CARDS = 4


def peaks(n: int) -> list[float]:
    return [torch.cuda.max_memory_allocated(i) / 1e9 for i in range(n)]


def main() -> int:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < MIN_CARDS:
        raise RuntimeError(f"mesh_serve_cards needs {MIN_CARDS} visible cards, "
                           f"found {n}")
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.smi_line()
    print(smi, flush=True)
    cuda_lib.build_all(["embedding_gather"])
    plan = plan_mesh(n)
    mesh = make_mesh_from_plan(plan.shape, plan.axis_names)
    cs.phase("cards", f"{n} cards: mesh {mesh.shape} ({plan.note})")
    cfg = configs.get_config(ARCH)
    rng = np.random.default_rng(cs.LM_SEED)
    prompts = rng.integers(0, cfg.vocab_size,
                           (cs.LM_REQUESTS, cs.LM_PROMPT)).astype(np.int32)

    # the 2-layer cut: born sharded against unsharded on card 0
    cut = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    whole = M.init_params(M.make_generator(cs.LM_SEED, "cuda:0"), cut)
    want = cs.greedy_steps(torch, np, M, whole, cut, prompts[:cs.LM_SLOTS],
                           cs.LM_NEW_TOKENS)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    born = M.init_params(M.make_generator(cs.LM_SEED, "cuda:0"), cut, mesh=mesh)
    got = cs.greedy_steps(torch, np, M, born, cut, prompts[:cs.LM_SLOTS],
                          cs.LM_NEW_TOKENS, mesh=mesh)
    tol = cs.MESH_LOGIT_RTOL * max(1.0, float(np.abs(want["steps"]).max()))
    step_err = float(np.abs(got["steps"] - want["steps"]).max())
    if step_err > tol:
        raise AssertionError(f"2-layer cut: logits differ by {step_err:.3e} "
                             f"> {tol:.3e}")
    checked, close = cs.margin_rule(got["tokens"], want["tokens"],
                                    want["margins"], tol, label="cards check")
    cs.phase("cards", f"{cut.name} cut to {CHECK_LAYERS} layers: born sharded "
             f"on {mesh.shape} against unsharded on cuda:0: last logits within "
             f"{step_err:.3e} (limit {tol:.3e}), {len(checked)} greedy tokens "
             f"equal, {len(close)} within the margin")
    del born
    gc.collect()
    torch.cuda.empty_cache()

    # the whole model, born sharded
    for i in range(n):
        torch.cuda.reset_peak_memory_stats(i)
    t0 = time.perf_counter()
    params = M.init_params(M.make_generator(cs.LM_SEED, "cuda:0"), cfg, mesh=mesh)
    for i in range(n):
        torch.cuda.synchronize(i)
    init_s = time.perf_counter() - t0
    held = [torch.cuda.memory_allocated(i) / 1e9 for i in range(n)]
    cs.phase("cards", f"{cfg.name}: {cfg.n_layers} layers born sharded in "
             f"{init_s:.1f} s; GB allocated a card {[round(g, 2) for g in held]}"
             f", peak {[round(g, 2) for g in peaks(n)]}")
    gather_k.SHARD_LAUNCHES = 0
    steps = cs.greedy_steps(torch, np, M, params, cfg, prompts[:cs.LM_SLOTS],
                            cs.LM_NEW_TOKENS, mesh=mesh)
    toks, tps = cs.serve_batcher(torch, serve, cfg, params, prompts, mesh)
    if gather_k.SHARD_LAUNCHES == 0:
        raise AssertionError("no B9 shard launch on the mesh")
    if len(toks) != cs.LM_REQUESTS or any(len(t) != cs.LM_NEW_TOKENS
                                          for t in toks.values()):
        raise AssertionError("the batcher did not serve every request")
    peak = peaks(n)
    cs.phase("cards", f"{cfg.name} on {mesh.shape}: prefill ({cs.LM_SLOTS}, "
             f"{cs.LM_PROMPT}) {steps['prefill_ms']:.2f} ms, decode "
             f"{steps['decode_ms']:.2f} ms a step of {cs.LM_SLOTS}; batcher "
             f"{cs.LM_REQUESTS} requests x {cs.LM_PROMPT} tokens, "
             f"{cs.LM_NEW_TOKENS} new: {tps:.2f} tokens/s; peak GB a card "
             f"{[round(g, 2) for g in peak]}; B9 shard launches "
             f"{gather_k.SHARD_LAUNCHES} | {smi}")
    for rid in sorted(toks)[:3]:
        cs.phase("cards", f"  request {rid}: {toks[rid][:8]}...")
    print(json.dumps({"arch": cfg.name, "cards": n, "mesh": mesh.shape,
                      "init_s": init_s, "allocated_gb": held, "peak_gb": peak,
                      "prefill_ms": steps["prefill_ms"],
                      "decode_ms": steps["decode_ms"], "tokens_per_s": tps,
                      "check_err": step_err, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
