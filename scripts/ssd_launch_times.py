"""Kernel B8's launches timed alone on the card, forward and backward, and
B9's backward launch beside what bounds it.

* Forward, at mamba2-2.7b's prefill widths (l 512, h 80, p 64, g 1, n 128,
  chunk 256, fp32) and b = 1, 2, 4, 8: each launch of ``csrc/ssd_fused.cu``
  through its C entry point (median of 10 CUDA-event timings after 2, the
  L2 flushed; the state pass also without the flush), then the whole
  ``ssd_fused`` call, its error against ``ssd_fused_ref`` checked as
  ``chip_smoke.py`` does.
* Backward, at the train step's scan shape (b 2, the same widths): each
  launch of ``csrc/ssd_bwd.cu`` alone through its C entry point (the
  closures of ``repro_torch.kernels.ssd._bwd_calls``, in their order once
  first, so every launch reads what the launches before it wrote), then
  the whole ``ssd_fused_bwd`` call (and its host time a call, from a
  synchronized start), its error against ``ssd_fused_bwd_ref``.
* The no-grad wrapper in turns (b 1): ``ssd_fused`` against the wrapper
  as it was before the forward kept its cum and entering states for the
  backward (one scratch allocation for cum, the chunk states and the
  entering states; no autograd check), old / new / new / old, twice.
* B9's backward at the train step's T = 1024 ids of mamba2-2.7b into its
  (50280, 2560) fp32 table: ``torch.zeros`` of the table (the zero-fill at
  the library's rate) and ``zeros + index_add_``; the launch alone through
  its C entry point on the train stream's ids, on uniform ids and on
  all-equal ids (the zero-fill and the id scan with next to no sums), at
  the planned grid and at stripes of 32 and 128 rows; the wrapper and its
  host time a call.  The committed kernel's result is held ``torch.equal``
  to the plain version at each grid.

Run from the repository root on a machine with an NVIDIA GPU (~1 min):

    python3 scripts/ssd_launch_times.py [fwd] [bwd] [turns] [gather]

(no argument: all four).
"""
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import autotune  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import cuda_lib, gather, ssd  # noqa: E402

L, H, P, G, N, Q = 512, 80, 64, 1, 128, 256
TRAIN_B = 2


def forward_times(flush) -> None:
    lib = cuda_lib.library("ssd_fused")
    stream = torch.cuda.current_stream().cuda_stream
    no_flush = torch.empty(1, device="cuda")
    for b in (1, 2, 4, 8):
        (xd, ad, B, C), _ = cs.ssd_inputs(torch, np, b, L, H, P, G, N, "float32", seed=11)
        cum = torch.empty((b, H, L), device="cuda")
        states = torch.empty((b, H, L // Q, P, N), device="cuda")
        entering = torch.empty_like(states)
        y = torch.empty_like(xd)
        fstate = torch.empty((b, H, P, N), device="cuda")

        def chunk_state():
            return lib.repro_ssd_chunk_state(
                xd.data_ptr(), ad.data_ptr(), B.data_ptr(), cum.data_ptr(),
                states.data_ptr(), b, L, H, P, G, N, Q, 0, stream)

        def state_pass():
            return lib.repro_ssd_state_pass(
                states.data_ptr(), entering.data_ptr(), cum.data_ptr(), None,
                fstate.data_ptr(), b, L, H, P, N, Q, 0, stream)

        def chunk_output():
            return lib.repro_ssd_chunk_output(
                xd.data_ptr(), B.data_ptr(), C.data_ptr(), cum.data_ptr(),
                entering.data_ptr(), 0, y.data_ptr(), None, b, L, H, P, G, N, Q, 0,
                stream)

        for launch in (chunk_state, state_pass, chunk_output):
            if launch():
                raise RuntimeError(f"{launch.__name__} was refused")
        torch.cuda.synchronize()
        times = {f.__name__: cs.time_ms(torch, f, flush)
                 for f in (chunk_state, state_pass, chunk_output)}
        call = cs.time_ms(torch, lambda: ssd.ssd_fused(xd, ad, B, C, chunk=Q), flush)
        print(f"b={b}: chunk_state {times['chunk_state']:.4f} state_pass "
              f"{times['state_pass']:.4f} (no flush "
              f"{cs.time_ms(torch, state_pass, no_flush):.4f}) chunk_output "
              f"{times['chunk_output']:.4f} all {call:.4f} ms", flush=True)
        got = ssd.ssd_fused(xd, ad, B, C, chunk=Q)
        want = ssd.ssd_fused_ref(xd, ad, B, C, chunk=Q)
        print("  err", cs.ssd_violation(torch, got[0], want[0], "float32"),
              cs.ssd_violation(torch, got[1], want[1], "float32"), flush=True)


def backward_times(flush) -> None:
    b = TRAIN_B
    lib = cuda_lib.library("ssd_bwd")
    stream = torch.cuda.current_stream().cuda_stream
    (xd, ad, B, C), _ = cs.ssd_inputs(torch, np, b, L, H, P, G, N, "float32", seed=12)
    dy = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (b, L, H, P)).astype(np.float32)).cuda()
    _, fstate, cum, entering = ssd._forward(xd, ad, B, C, Q, None, keep=True)
    buf = ssd._BwdBuffers(xd, B, None, Q)
    calls = ssd._bwd_calls(lib, xd, B, C, dy, None, None, fstate, cum, entering,
                           Q, buf, stream)
    for name in autotune.SSD_BWD_LAUNCHES:
        if calls[name]():
            raise RuntimeError(f"{name} was refused")
    torch.cuda.synchronize()
    times = {name: cs.time_ms(torch, calls[name], flush)
             for name in autotune.SSD_BWD_LAUNCHES}
    saved = (fstate, cum, entering)
    call = cs.time_ms(torch, lambda: ssd.ssd_fused_bwd(
        xd, ad, B, C, dy, chunk=Q, saved=saved), flush)
    host = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = cs.time.perf_counter()
        ssd.ssd_fused_bwd(xd, ad, B, C, dy, chunk=Q, saved=saved)
        host.append((cs.time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    flops = autotune.ssd_bwd_flops(b, L, H, P, N, Q)
    parts = " ".join(f"{k} {v:.4f}" for k, v in times.items())
    print(f"backward (b, l, h, p, g, n) = {(b, L, H, P, G, N)} chunk {Q} fp32: "
          f"{parts} | sum {sum(times.values()):.4f} | call {call:.4f} ms, host "
          f"{statistics.median(host):.1f} us a call | "
          f"bound {flops / cs.FP32_OPS * 1e3:.4f} ms (CUDA cores), 3xTF32 floor "
          f"{3 * flops / cs.TF32_OPS * 1e3:.4f} ms", flush=True)
    got = ssd.ssd_fused_bwd(xd, ad, B, C, dy, chunk=Q, saved=saved)
    want = ssd.ssd_fused_bwd_ref(xd, ad, B, C, dy, chunk=Q)
    print("  err", [cs.ssd_violation(torch, gv, wv, "float32")
                    for gv, wv in zip(got[:4], want[:4])], flush=True)


def _ssd_fused_one_alloc(xd, ad, B, C, chunk):
    """The no-grad wrapper before the forward kept its states for the
    backward: one scratch block for cum, the chunk states and the entering
    states, the three launches, no autograd check."""
    lib = cuda_lib.library("ssd_fused")
    b, l, h, p = xd.shape
    g, n = B.shape[2], B.shape[3]
    ssd._plan(b, l, h, p, g, n, chunk, xd.dtype).raise_if_invalid()
    xd, ad, B, C = (t.contiguous() for t in (xd, ad, B, C))
    y = torch.empty_like(xd)
    fstate = torch.empty((b, h, p, n), dtype=xd.dtype, device=xd.device)
    nc = l // chunk
    n_cum = -(-b * h * l // 4) * 4
    n_st = b * h * nc * p * n
    scratch = torch.empty(n_cum + 2 * n_st, dtype=xd.dtype, device=xd.device)
    cum = scratch[:b * h * l]
    states = scratch[n_cum:n_cum + n_st]
    entering = scratch[n_cum + n_st:]
    with torch.cuda.device(xd.device):
        stream = torch.cuda.current_stream().cuda_stream
        for err in (
                lib.repro_ssd_chunk_state(
                    xd.data_ptr(), ad.data_ptr(), B.data_ptr(), cum.data_ptr(),
                    states.data_ptr(), b, l, h, p, g, n, chunk, 0, stream),
                lib.repro_ssd_state_pass(
                    states.data_ptr(), entering.data_ptr(), cum.data_ptr(), None,
                    fstate.data_ptr(), b, l, h, p, n, chunk, 0, stream),
                lib.repro_ssd_chunk_output(
                    xd.data_ptr(), B.data_ptr(), C.data_ptr(), cum.data_ptr(),
                    entering.data_ptr(), 0, y.data_ptr(), None, b, l, h, p, g, n,
                    chunk, 0, stream)):
            if err:
                raise RuntimeError(f"launch refused ({err})")
    return y, fstate


def wrapper_turns(flush) -> None:
    (xd, ad, B, C), _ = cs.ssd_inputs(torch, np, 1, L, H, P, G, N, "float32", seed=11)
    old = lambda: _ssd_fused_one_alloc(xd, ad, B, C, Q)          # noqa: E731
    new = lambda: ssd.ssd_fused(xd, ad, B, C, chunk=Q)            # noqa: E731
    a, b = old(), new()
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise AssertionError("the two wrappers disagree")
    readings = {"one allocation": [], "current": []}
    for _ in range(2):
        for name, fn in (("one allocation", old), ("current", new),
                         ("current", new), ("one allocation", old)):
            readings[name].append(cs.time_ms(torch, fn, flush))
    host = {}
    for name, fn in (("one allocation", old), ("current", new)):
        torch.cuda.synchronize()
        ts = []
        for _ in range(200):
            t0 = cs.time.perf_counter()
            fn()
            ts.append((cs.time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        host[name] = statistics.median(ts)
    for name, ms in readings.items():
        print(f"no-grad ssd_fused (1, {L}, {H}, {P}, {G}, {N}) chunk {Q}, {name}: "
              f"{' '.join(f'{v:.4f}' for v in ms)} ms (median "
              f"{statistics.median(ms):.4f}); host {host[name]:.1f} us a call",
              flush=True)


def gather_bwd_times(flush) -> None:
    cfg = configs.get_config("mamba2-2.7b")
    v, d, t = cfg.vocab_size, cfg.d_model, cs.TRAIN_BATCH * cs.TRAIN_SEQ
    train = torch.from_numpy(cs.train_batch(np, cfg, cs.TRAIN_BATCH)["tokens"]
                             .reshape(-1).astype(np.int64)).cuda()
    streams = {"train ids": train,
               "uniform ids": torch.from_numpy(
                   np.random.default_rng(5).integers(0, v, t)).cuda(),
               "all-equal ids": torch.full((t,), 7, dtype=torch.int64,
                                           device="cuda")}
    dout = torch.randn((t, d), device="cuda")
    dtable = torch.empty((v, d), device="cuda")
    lib = cuda_lib.library("embedding_gather")
    stream = torch.cuda.current_stream().cuda_stream
    stripe0, chunks, threads, vec = autotune.gather_bwd_grid(v, d, t, 4)
    zeros_ms = cs.time_ms(torch, lambda: torch.zeros((v, d), device="cuda"), flush)
    bound = ((v * d + t * d) * 4 + 8 * t) / cs.HBM_BYTES_PER_S * 1e3
    print(f"B9 backward T={t} into ({v}, {d}) fp32: train ids "
          f"{int(train.unique().numel())} distinct, the longest run "
          f"{int(torch.bincount(train).max())}; bound {bound:.4f} ms (bytes); "
          f"torch.zeros {zeros_ms:.4f} ms", flush=True)
    for name, ids in streams.items():
        want = gather.embedding_gather_bwd_ref(dout, ids, v)
        lib_ms = cs.time_ms(torch, lambda: torch.zeros((v, d), device="cuda")
                            .index_add_(0, ids, dout), flush)
        parts = []
        for stripe in (stripe0, 32, 128):
            def launch():
                return lib.repro_embedding_gather_bwd(
                    ids.data_ptr(), 8, dout.data_ptr(), dtable.data_ptr(), None, v,
                    t, d, 0, 0, vec, stripe, chunks, threads, stream)
            if launch():
                raise RuntimeError(f"B9 backward refused at stripe {stripe}")
            if not torch.equal(dtable, want):
                raise AssertionError(f"B9 backward at stripe {stripe} differs "
                                     "from its plain version")
            parts.append(f"stripe {stripe} {cs.time_ms(torch, launch, flush):.4f}")
        print(f"  {name}: launch alone ({chunks} chunks of {threads}, {vec} B "
              f"vectors) {' | '.join(parts)} ms | zeros + index_add_ "
              f"{lib_ms:.4f} ms", flush=True)
    wrapper = cs.time_ms(torch, lambda: gather.embedding_gather_bwd(dout, train, v),
                         flush)
    host = []
    for _ in range(200):
        torch.cuda.synchronize()
        t0 = cs.time.perf_counter()
        gather.embedding_gather_bwd(dout, train, v)
        host.append((cs.time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    print(f"  the wrapper on the train ids: {wrapper:.4f} ms, host "
          f"{statistics.median(host):.1f} us a call", flush=True)


def main() -> int:
    want = set(sys.argv[1:]) or {"fwd", "bwd", "turns", "gather"}
    print(cs.smi_line(), flush=True)
    flush = torch.empty(25_000_000, dtype=torch.float32, device="cuda")
    if "fwd" in want:
        forward_times(flush)
    if "bwd" in want:
        backward_times(flush)
    if "turns" in want:
        wrapper_turns(flush)
    if "gather" in want:
        gather_bwd_times(flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
