#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as it completes; any failure exits non-zero before the
result line is printed:

1. device   — the card's name and power limit (``nvidia-smi``);
2. build    — every CUDA kernel of the main paths (``spmm_sell.cu``,
              ``spmm_sell_stream.cu``, ``graph_step.cu``, ``spmv_ell.cu``,
              ``fft_stockham.cu``, ``ssd_fused.cu``, ``ssd_bwd.cu``,
              ``embedding_gather.cu``),
              built from ``src/`` with ``nvcc`` (one process per source,
              started together);
3. compare  — each kernel against its plain PyTorch version on the card:
              B1 (``spmm_sell``) over C x k x dtype on two operands; B2
              (``spmm_sell_stream``) over C x k x dtype x tiles on two
              operands (the (64, 3) tiles give blocks whose column lists
              take several chunks), bit-equal to B1 where B1 splits no
              bucket across threads (else within 1e-10 fp64 / 1e-4 x
              max|y| fp32), also on rows out of column order and with PAD
              before a row's entries; the graph kernels B3
              (``bfs_step_sell``, ``pagerank_step_sell``; its split
              buckets at k 1, 3, 8 and 32 among them), B4 (``bfs_step``:
              its frontier pass ``bfs_frontier`` and its walk, every
              level) and B5 (``pagerank_step``, two calls bit-equal) over
              RMAT and uniform graphs at 2^12 and a prime node count, C x
              k, B4 / B5 also on an adjacency with PAD inside rows and a
              warp of all-PAD nodes, with their live widths against a host
              count; B6
              (``spmv_ell``) over C x dtype on two operands, packed and
              with PAD inside rows and a warp of all-PAD rows, its live
              widths against a host count, and its k-column form
              (``spmm_ell``, k in 1, 2, 3, 8, 32, 33) torch.equal to the
              column-by-column launches and within tolerance of
              ``spmm_ell_ref``; B7
              (``fft_stockham``, the in-block and the two-pass form) over
              n x batch x dtype, and the two-pass form's tiles, each form
              reading row 0 of the twiddle tables only; B8
              (``ssd_fused``, three launches a call) at mamba2-2.7b's
              prefill shapes (b 1 and 4) and three chunks at its widths,
              at small shapes in fp32 and fp64 (three chunks over 160
              (b, h) planes among them) and at hymba-1.5b's prefill shapes
              ((1 and 4, 512), (1, 2560): h 50, p 64, n 16, chunk 256) in
              fp32 and fp64, from a zero and a random state;
              B9 (``embedding_gather``) from mamba2's
              (50,280, 2560) table at T in (1, 4, 512, 2048), fp32 and
              fp64, int32 and int64 ids on the host and on the card,
              exactly, one launch a call, and ids on the card outside
              [0, V) equal to ``table[clamp_ids(ids)]`` with the context
              usable after them; B4 / B5 / B6 handed live widths W + 5
              (equal to the true widths') and -1 (no slot walked, equal to
              the plain path handed the same widths);
4. main     — the SpMV path as a user drives it: a ``KernelRegistry`` on the
              card registers cage10 and a 2,097,152-row operand, a
              ``KernelService(n_slots=32)`` serves 64 SpMV requests, every
              result is checked; B1's launch count is read around it;
5. graphs   — the graph path as a user drives it: the registry registers
              rmat15 (2^15 nodes) and uniform21 (2^21 nodes), the service
              serves 32 BFS and 32 PageRank requests per graph (groups of
              k = 32), every result is checked against the plain drive on
              the card and some against the host references; then
              ``ops.bfs`` / ``ops.pagerank`` on the ELLPACK layout; each
              graph kernel's launch count is read around its drive;
6. fft      — the FFT path as a user drives it: the registry registers the
              plans fft2048 and fft131072 and cage10, one service drain
              serves 32 FFT requests per plan ((256, 2048) and (8, 2^17)
              float64 signals) mixed with 16 SpMV requests; every result
              is checked against the plain version on the card, four per
              plan against ``np.fft.fft``; B7's launch counts (in-block,
              two-pass)
              are read around the drain;
7. ellpack  — ``ops.spmv`` on cage10 and ``ops.spmm`` (k = 32) on a
              2,097,152-row uniform operand, both as ELLPACK at C = vl =
              256 (kernel B6, no repack: one launch for the vector, one
              launch a k tile of the k-column form for the 32 columns),
              checked against the plain version on the card and the host
              ``EllpackMatrix.matvec``; B6's launch count is read around
              them (1 + k tiles);
8. stream   — the streaming schedule as a user drives it: ``ops.spmm`` with
              ``mode="stream"`` on cage10 (k = 32) and on a 8,192 x
              4,300,000 operand (k = 8), ``ops.spmv`` with it on the latter
              (k = 1), all through kernel B2 (its block column lists
              built by ``ops`` once per operand; a copy is built first to
              print the build time), each result bit-equal to B1 (no
              bucket of these operands is split)
              on the card and four columns against ``CSRMatrix.matvec``;
              B2's launch count is read around them;
9. moe      — MoE decode traffic at the published widths of mixtral-8x7b
              and deepseek-moe-16b: the registry registers one dispatch
              envelope per model, the service serves 32 routing requests
              per envelope (64-sequence decode steps), each envelope's
              group one block-diagonal launch set of kernel B1; every
              result is checked against the plain version on the card and
              the dense dispatch, four per envelope against ``R @ X`` in
              numpy; B1's launch count is read around each envelope's
              drain;
10. lm      — the LM serving path as a user drives it: mamba2-2.7b at its
              published widths and depth (64 layers, 2.7 B parameters,
              random init from a seed) on the card; a ``Batcher(n_slots=4)``
              serves 8 requests of 512-token prompts, 16 new tokens each
              (every prefill a chunk multiple: B8's three launches in
              each layer, B9 for its
              tokens and for every decode step), then one
              ``ServeEngine.generate`` on a (4, 512) batch; B8's and B9's
              launch counts are read around each drive; tokens/s, prefill
              ms a request and decode ms a step are printed; then a
              2-layer model at full width from the same weights runs on
              the card and on the CPU (plain versions): logits within
              ``LM_LOGIT_RTOL`` x max|logit|, greedy tokens equal wherever
              the CPU's top-2 margin exceeds that;
10b. lm-dense — the dense attention LM the same way: llama-3.2-3b at its
              published widths and depth (28 layers, 24 query / 8 kv
              heads of 128, 3.6 B parameters, random init from the same
              seed) through the batcher (8 requests of 512 tokens) and the
              engine ((4, 512)), B9's launches read around each drive and
              B8's (none) too, its 2-layer full-width card-vs-CPU check,
              and one b = 1 prefill and one b = 4 decode step under
              ``torch.profiler``; then its weights are freed;
11. timing  — every kernel at the main paths' shapes, CUDA events with the
              L2 flushed, beside its bound (the larger of the function's
              least bytes and its operations over the card's peak rates;
              the bytes count the rows of X that stored entries name),
              the same bytes over the padded layout (B6: also the slots
              its live widths walk, and k = 32 as one call beside the
              column-by-column walk and ``torch.sparse.mm`` at k = 32; B8:
              the flops its tiles execute and the form's floor, launch 1 at
              the CUDA cores' rate and launch 3's 3xTF32 products at the
              tensor cores'; the goals marked met or missed), the plain version
              and, where one PyTorch call computes the same function, that
              call (``torch.sparse.mm``, ``torch.fft.fft``,
              ``torch.nn.functional.embedding``; B9 also as a launch
              alone, its device time under ``torch.profiler`` and the
              host time a call, beside ``F.embedding`` read the same
              way); B2 beside B1
              at seven shapes with the bytes its schedule moves (staged X
              rows and column map) and the map's build time, and the
              rule ``mode="auto"`` follows; B3 per bucket with its lanes a
              node and parts, and the bytes of its state gather; B4 / B5
              with the live widths ``ops`` cached (their build timed on
              its own), B4 at each level of uniform21's drive beside its
              frontier pass, B5 beside its id-free reading (every id
              taken mod 2048: the gap is its gathers through the L2); the MoE launch sets beside the
              dense ``torch.matmul``; then one graph drive per (graph, op)
              under ``torch.profiler``: the graph kernels' device time
              against the drive's wall time; and one mamba2 prefill (b = 1)
              and decode step (b = 4) under it: the device's busy time
              against the wall time, and the kernels that take most;
11b. study  — the paper's sweep study as a user drives it
              (``repro_torch.core.campaign``): the four named campaigns,
              both paper claims checked on ``paper-fig3`` / ``paper-fig5``
              (no violations); ``measure_cuda`` times the four kernels
              through ``ops`` at each paper VL (8 .. 256) on the problems
              the traces model (cage10 as ELLPACK at C = vl: B6; BFS and
              10 PageRank steps on rmat15: B4, B5; one 2048-point fp64
              FFT: B7), CUDA events with the L2 flushed, every result
              held against its plain version on the card and the phase's
              launches counted, then 10 calls per kernel at VL 256 under
              ``torch.profiler`` (device busy time a call against the
              events' µs, which span ``ops``' host time); a user cube over
              ``h100_machine()`` prints
              modeled µs beside measured µs; both go to a ``SweepStore``
              under ``build/study/`` and are reloaded strictly (cubes
              ``==``); a fresh ``TuneCache`` warm-started from it narrows
              a ``KernelRegistry``'s candidate C on cage10 and rmat15
              against a cold registry's, and 32 SpMV requests are served
              on the warm cage10 (B1), each held against its plain
              version;
11c. sharded — the sharded SELL drives on a mesh naming the card
              SHARD_N = 4 times, as a user drives them: ``ops.spmv`` /
              ``ops.spmm`` on the 2,097,152-row operand with
              ``ExecSpec(placement=("cuda:0",) * 4)`` at k = 1 and 8
              (row-sharded: each shard's B1 launches against its X window)
              and k = 32 (RHS-sharded: whole k tiles a shard), then
              ``ops.bfs`` / ``ops.pagerank`` (k = 32, 20 steps, float64 and
              float32) on rmat15 and uniform21 node-partitioned (B3 a
              shard, frontiers folded by a minimum, ranks by a sum), then
              a ``KernelRegistry(mesh=...)`` and ``KernelService`` (32
              SpMV requests on the big operand, 32 BFS and 32 PageRank
              requests in each dtype a graph); every result ``torch.equal``
              to the serial fold (``mesh=None``) and to the unsharded port,
              or, where B1 or B3 splits a bucket of either layout (the
              parts' sums follow the slices a bucket has), within 1e-10 x
              max|y| (fp64) / 1e-4 x max|rank| (fp32); ``placement=2``
              raising on a one-card machine (on two cards: run and held to
              the one-card mesh); float32 PageRank through ``ops`` on both
              layouts (B3, B5) against the plain drives at 1e-4 x
              max|rank|; the phase's B1, B3 and B5 launches counted from
              0; then B3's and B5's float forms timed at uniform21's
              shapes beside their bounds, plain versions and
              ``torch.sparse.mm`` in fp32, the 4-shard fold on the card
              against the unsharded call, and each shard's X window and
              padded slices;
12. lm-moe  —the MoE LM, after every earlier phase's operands and models
              are freed: deepseek-moe-16b at its published widths and depth
              (a dense first layer, then 27 MoE layers of 64 routed experts
              top-6 and 2 shared, random init from the seed directly on the
              card) served on (4, 512) prompts, 16 new tokens, by the plain
              engine (the combines on the dense path, B9 for the tokens)
              and by the fused engine (a float32 ``register_moe``
              envelope; every combine a ``moe_dispatch`` request, kernel
              B1): the fused tokens equal the plain ones under the LM
              check's margin rule, ``moe_dispatch_launches`` = 27 x 16, as
              many routing reads, 16 token latencies, B1's and B9's launch
              counts read around each run, tokens/s, first-token and
              decode-step ms of both; B1 timed at the first MoE layer's
              prefill (2048 tokens x 15,616 slots) and decode (4 x 256)
              routing, k = 2048 fp32, beside its bound and
              ``torch.sparse.mm``; the 2-layer full-width check (the dense
              first layer and the first MoE layer) with the card's combine
              on B1 and the CPU's on the dense path; a prefill and a decode
              step under ``torch.profiler`` on each path; the peak device
              memory;
13. lm-families — the last three LM families, one at a time, each freed
              before the next, at their published widths and depth with
              random init from the seed on the card: hymba-1.5b (32
              hybrid layers: attention with a 2048-token window beside a
              mamba2 mixer; B8 in every layer of a chunk-multiple
              prefill), seamless-m4t-medium (a 12-layer bidirectional
              encoder, 12 decoder layers cross-attending its memory) and
              llama-3.2-vision-11b (10 groups of 4 self blocks, each
              followed by a cross block over 1601 projected patch
              embeddings); each served by ``Batcher(n_slots=4)`` (8
              requests of 512 tokens, 16 new each; no ``ctx_embeds``, so
              the zero context, as the reference's batcher) and by
              ``ServeEngine.generate`` on (4, 512) (seamless with (4, 1024,
              1024) stub frames, vision with (4, 1601, 1280) stub patch
              embeddings, numpy from the seed, as ``ctx_embeds``), B8's and
              B9's launches read around each drive, tokens/s, prefill ms
              and decode ms printed; its card-vs-CPU check cut in depth
              (hymba 2 layers, also on a 2560-token prompt whose ring of
              2048 slots wraps; seamless 2 encoder and 2 decoder layers;
              vision one group, 4 self blocks and a cross block); B8 timed
              at hymba's prefill shapes (b 1 and 4) beside its bound and
              plain version; a prefill and a decode step under
              ``torch.profiler``; the peak device memory;
14. train   — the training path: B8's backward (``ssd_fused_bwd``, five
              launches a call) against its plain version at the train
              step's scan shapes ((1 and 2, 512) at mamba2's widths, (1,
              512) at hymba's) in fp32 and fp64, from a zero and a random
              initial state, with and without a final-state gradient, two
              calls bit-equal; B9's backward (``embedding_gather_bwd``)
              from mamba2's table at T = 1024 and 4, equal to its plain
              version and within 1e-6 x max of ``index_add_``; a 2-layer
              full-width mamba2 train step on the card against the CPU
              (loss 1e-5 relative, each gradient 1e-4 x max|g|) and under
              remat "full" against none (1e-6 x max|g|); mamba2-2.7b at
              full width and depth trained 3 steps of (2, 512) tokens
              through the port's CLI (``repro_torch.launch.train``, remat
              "full", lr 3e-4; the four counts set to 0 just before and
              read just after): each step's loss, grad norm and ms,
              tokens/s, the peak device memory, then one more step under
              ``torch.profiler`` (the device's busy share, B8's and B9's
              forward and backward shares, the launches split forward /
              backward, the remat recompute among the latter); resume on
              the card at the reduced config (crashed at step 5, restarted
              from the step-4 checkpoint, within 1e-6 of an uninterrupted
              run); both backward kernels timed at the train step's shapes
              beside their bounds, plain versions and (B9) ``zeros +
              index_add_``;
15. mesh    — the dense and MoE families over (data, model) meshes that
              name the card data x model times (one process drives every
              device of a mesh): B9's vocab-shard form against its plain
              version (4 row shards of mixtral's and llama's tables, T =
              512 and 4, int32 / int64 ids on every shard boundary and
              outside [0, V), ``torch.equal``, the shards summing to the
              whole-table gather); mixtral-8x7b at full width cut to 2
              layers on (1, 4), (2, 2) and (1, 16), deepseek-moe-16b cut to
              2 (its dense first layer and one MoE layer) on (1, 4) and
              llama-3.2-3b at full width and depth on (1, 4), each placed by
              the partition rules from the unsharded model's weights:
              prefill logits of (4, 512) prompts and 4 decode steps within
              1e-4 x max|logit| of the unsharded port (MoE combines on B1),
              greedy tokens equal past the margin, ``Batcher(n_slots=4)``
              on 8 requests of 512 tokens and 16 new, every token equal
              to the unsharded continuation past the margin; mixtral's
              plain and fused engines on (1, 4) (the fused combines on B1
              through a service on the lead device); prefill ms, decode ms
              a step and tokens/s a mesh; B9's shard form and B1's
              launches counted around each mesh's drive; the shard form
              timed at mixtral's and llama's shards beside the whole-table
              B9, the plain version and its bound;
16. mesh-train — training over (data, model) meshes naming the card four
              times, and mamba2 on a mesh: B9's shard backward
              (``embedding_gather_shard_bwd``) against its plain version
              on mamba2's four (12570, 2560) row shards, T = 4 / 512 /
              1024, int32 / int64 ids with card ids outside [0, V),
              ``torch.equal``, the shards stacked ``torch.equal`` to the
              whole-table backward; one step of 2-layer full-width cuts of
              mamba2-2.7b on (1, 4) and (2, 2), llama-3.2-3b and
              deepseek-moe-16b on (1, 4) against the unsharded port on the
              card (loss 1e-5 relative, every gradient 1e-4 x max|g|, the
              grad norm 1e-5, AdamW on the mesh's ZeRO-1 blocks given the
              unsharded gradients 1e-6 x max|p|, every block's pieces
              equal after a step); mamba2 2 layers served on (1, 4) (B8 a
              head shard: prefill and decode logits within 1e-4 x
              max|logit|, engine and batcher tokens past the margin); the
              main path, mamba2-2.7b at full width and depth trained 3
              steps of (2, 512) on (1, 4) through ``train_loop(mesh=)``
              (born sharded, remat "full"; B8, its backward, B9's shard
              form and shard backward counted from 0): step ms, tokens/s,
              peak GB beside the unsharded step's, one more step under
              ``torch.profiler``; a crash and resume on (2, 2) and the
              mesh checkpoint restored on one device, ``torch.equal``; the
              shard backward timed beside its bound, plain version and
              ``zeros + index_add_``;
17. mesh-families — the hybrid, enc-dec and vision families on (1, 4)
              and (2, 2) meshes naming the card four times: hymba-1.5b,
              seamless-m4t-medium and llama-3.2-vision-11b at full width
              and depth (vision on (2, 2) at its first 20 layers: two
              data replicas of its 47.85 GB do not fit the card), each run
              unsharded first (its logits and tokens kept on the host, the
              model freed), then born sharded from the same seed: a (4,
              512) prefill with stub ``ctx_embeds`` and 4 decode steps
              reading the context back within 1e-4 x max|logit| of the
              unsharded run, greedy tokens, the engine's (with
              ``extras``) and the batcher's (8 requests against the zero
              context) equal past the margin; prefill ms, decode ms a step,
              batcher tokens/s and GB a device beside the unsharded
              readings; B8 (hymba: 25 heads a device on (2, 2), all 50 on
              the lead on (1, 4)) and B9 (its shard form where the
              vocabulary divides) counted from 0 around each mesh's drive;
              then one train step of hymba's 2-layer full-width cut on
              each mesh against the unsharded step (phase 16's
              tolerances), and the loss and gradients of seamless's (2
              encoder and 2 decoder layers) and vision's (its first group)
              cuts with ``ctx_embeds``;
18. bf16    — the bf16 forms of B8 and B9: B8 on bf16 xd / B / C with
              float32 ad (phase 3's float32 cases, mamba2's and hymba's
              prefill shapes among them, and p past one 64-column slice)
              ``torch.equal`` to its fp32 form on the upcast inputs with y
              rounded once and the state equal, its backward (phase 14's
              cases) each output the fp32 backward's rounded, B9's gather,
              shard form, backward and shard backward on mamba2's table and
              one of odd d in bf16 (T in 1, 4, 512, 2048, 4096; int32 /
              int64 ids on the host and the card, out-of-range card ids)
              ``torch.equal`` to their contracts, the backwards from bf16
              and from float32 output gradients; mamba2-2.7b at full width
              and depth with bf16 weights and ``SSD_BF16`` served by
              ``Batcher(n_slots=4)`` (4 requests of 512 tokens, 8 new; B8's
              and B9's bf16 launches counted from 0), its 2-layer cut card
              vs CPU at 1e-2 x max|logit|; 2 train steps of (2, 512) through
              ``train_loop`` with ``TrainConfig(param_dtype=bfloat16)``
              under ``SSD_BF16``; a 2-layer
              step card vs CPU (loss 1e-5 relative, gradients 1e-2 x
              max|g|), ``torch.equal`` to the copy-then-gather step with
              ``SSD_BF16`` off, and on (1, 4) with B9's shard forms counted;
              each form timed beside its fp32 form, its bound, its plain
              version and (B9) ``F.embedding`` / ``zeros + index_add_``;
19. flags   — the reference's five opt-in attention and placement flags,
              set as the port's module attributes and restored after:
              (a) llama-3.2-3b with ``ATTN_KV_CHUNK`` = 128, 4 x (512 +
              16) through ``Batcher(n_slots=4)`` and a (4, 512) prefill
              with decode steps, logits within 1e-5 x max|logit| of the
              flag-off run, tokens equal past that margin, prefill ms and
              peak memory both ways; (b) llama-3.2-3b in bf16 activations
              with ``ATTN_BF16_SCORES``: the whole model's logits and its
              2-layer full-width cut's within 5e-2 x max|logit| of the
              bf16 runs without it, the cut's card logits of the CPU's
              under the flag (bf16 activations part card and CPU by ~1e-2
              without it: printed beside); (c) hymba-1.5b's 2560-token
              prefill (past its 2048-slot ring) with ``ATTN_KV_CHUNK`` =
              256 and decode steps, every position against the flag-off
              forward without a cache over the prompt and the tokens fed
              (1e-4 x max|logit|), prefill ms and peak memory both ways;
              (d) hymba-1.5b on (1, 4) with ``SEQ_SHARD_FALLBACK`` and
              ``KV_SEQ_SHARD``, qwen2-1.5b on (1, 4) with ``KV_SEQ_SHARD``,
              each against its unsharded run (1e-4 x max|logit|, tokens
              equal past the margin), the k / v bytes a device and decode
              ms; (e) llama-3.2-3b on (2, 2) with and without
              ``FSDP_PARAMS``, logits ``torch.equal``, the resident
              parameter bytes both ways, and two train steps of its 2-layer
              cut, losses and updated parameters equal; B8's and B9's
              launches counted from 0 around each drive.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
one JSON object with a record per kernel.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: H100 SXM data sheet: HBM3 bandwidth, fp64 and fp32 (non-tensor) peaks
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
FP32_OPS = 67e12
#: H100 SXM data sheet: dense TF32 tensor-core peak
TF32_OPS = 495e12
BIG = dict(n_rows=2_097_152, n_cols=2_097_152, avg_nnz_row=16.0, seed=0,
           skew=1.0)
N_SLOTS = 32
REQUESTS_PER_OPERAND = 32
#: the graph path's operands: generator name and arguments
GRAPHS = {
    "rmat15": ("rmat_graph", dict(n_nodes=1 << 15, avg_degree=16, seed=0)),
    "uniform21": ("random_graph", dict(n_nodes=1 << 21, avg_degree=16,
                                       seed=0)),
}
#: the FFT path's plans: registered length and signal rows per request
FFT_PLANS = {"fft2048": (2048, 256), "fft131072": (1 << 17, 8)}
FFT_REQUESTS_PER_PLAN = 32
FFT_SPMV_REQUESTS = 16
#: B7 compare cases: both forms, both sides of the shared-memory limit
#: (the two-pass form at 8192 and 2^17 in fp64, 2^17 and 2^20 in both)
FFT_COMPARE_NS = (2, 8, 64, 512, 2048, 4096, 8192, 1 << 17, 1 << 20)
FFT_COMPARE_BATCHES = (1, 3, 8, 13)
#: the ELLPACK ops path's operand: uniform (Poisson) row lengths
ELL_BIG = dict(n_rows=2_097_152, n_cols=2_097_152, avg_nnz_row=16.0, seed=0)
ELL_C = 256
ELL_K = 32
#: Column counts of B6's k-form compare cases (33: a ragged second tile)
ELL_COMPARE_KS = (1, 2, 3, 8, 32, 33)
#: the streaming phase's rectangular operand (the reference's
#: tests/test_stream.py giant: X is 34 MB a column)
GIANT = dict(n_rows=8192, n_cols=4_300_000, avg_nnz_row=2.0, seed=3)
GIANT_K = 8
#: MoE decode traffic: one dispatch envelope per model at its published
#: width (src/repro/configs/mixtral_8x7b.py, deepseek_moe_16b.py); each
#: request is one decode step of a batch of MOE_TOKENS sequences routed as
#: one group, capacity int(tokens * top_k / experts * 1.25) + 1 a expert
#: (src/repro/models/moe.py)
MOE_MODELS = {
    "mixtral-8x7b": dict(d_model=4096, n_experts=8, top_k=2),
    "deepseek-moe-16b": dict(d_model=2048, n_experts=64, top_k=6),
}
MOE_TOKENS = 64
MOE_CAPACITY_FACTOR = 1.25
MOE_REQUESTS = 32
MOE_C = 32
DAMPINGS = (0.85, 0.9, 0.8, 0.95)
ITERS = 20
PR_RTOL = 1e-10
#: PageRank columns a graph held to the host's pagerank_reference (every
#: column is held to the plain drive on the card)
GRAPH_HOST_PR_COLUMNS = 1
#: the LM phase (kernels B8, B9): mamba2-2.7b at its published widths and
#: depth (src/repro_torch/configs/mamba2_2_7b.py), random init from LM_SEED
LM_ARCH = "mamba2-2.7b"
LM_SEED = 0
LM_SLOTS = 4
LM_REQUESTS = 8
#: two of mamba2's 256-row chunks: every prefill runs B8
LM_PROMPT = 512
LM_NEW_TOKENS = 16
#: the dense attention LM phase (kernel B9): llama-3.2-3b at its published
#: widths and depth (src/repro_torch/configs/llama3_2_3b.py), random init
#: from LM_SEED, served the same way as LM_ARCH
LM_DENSE_ARCH = "llama3.2-3b"
#: the MoE LM phase (kernel B1 on the LM's combines, B9 for the tokens):
#: deepseek-moe-16b at its published widths and depth
#: (src/repro_torch/configs/deepseek_moe_16b.py, 67.5 GB of fp32 weights),
#: random init from LM_SEED on the card, served by the plain engine and by
#: the fused one (every combine a moe_dispatch request on the service)
LM_MOE_ARCH = "deepseek-moe-16b"
#: the families phase (kernels B8, B9): the last three LM families at their
#: published widths (src/repro_torch/configs/hymba_1_5b.py,
#: seamless_m4t_medium.py, llama3_2_vision_11b.py), one at a time, each
#: freed before the next, random init from LM_SEED on the card
LM_FAMILY_ARCHS = ("hymba-1.5b", "seamless-m4t-medium", "llama-3.2-vision-11b")
#: hymba's long check prompt: ten 256-row chunks (B8's path), past its
#: 2048-token sliding window (the ring of 2048 slots wraps)
LM_HYMBA_LONG = 2560
#: depth of the card-against-CPU check (full width, the first layers)
LM_CHECK_LAYERS = 2
#: card logits against the CPU's plain versions, relative to max|logit|:
#: fp32 rounding in other summation orders (cuBLAS, B8) over two layers
LM_LOGIT_RTOL = 1e-4
#: B8 compare tolerances (the reference's, tests/test_kernels.py:273); the
#: fp32 absolute part is taken relative to max(1, max|y|), since at
#: mamba2's widths y sums 256 x 128 products and reaches |y| ~ 1e2
SSD_TOL = {"float32": 2e-4, "float64": 1e-10}
#: B8's time goals at the LM prefill shape, by batch (ms)
SSD_GOAL_MS = {1: 0.40, 4: 1.2}
#: B9 compare: ids per call (a decode step of one and of four sequences, a
#: prefill, four prefills)
GATHER_TS = (1, 4, 512, 2048)
#: B9 timing: id sets a reading rotates over, drawn across the whole table
#: (16 x 512 rows x 10 KB = 84 MB, past the 50 MB L2), raw launches between
#: one event pair, and wrapper calls timed on the host clock
GATHER_ID_SETS = 16
GATHER_LAUNCH_REPS = 64
GATHER_HOST_CALLS = 256
#: the train phase (B8 and B9 forward and backward): mamba2-2.7b at full
#: width trained through the port's CLI, TRAIN_STEPS steps of
#: TRAIN_BATCH x TRAIN_SEQ tokens under remat "full", fp32
TRAIN_ARCH = "mamba2-2.7b"
TRAIN_BATCH = 2
TRAIN_SEQ = 512
TRAIN_STEPS = 3
TRAIN_LR = 3e-4
TRAIN_REMAT = "full"
#: the 2-layer card-vs-CPU train step: its batch, and the loss (relative),
#: gradient (x max|g| of the CPU's tensor) and remat (x max|g|) tolerances
TRAIN_CHECK_BATCH = 1
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
TRAIN_REMAT_TOL = 1e-6
#: the resume check: the reference's bound, its checkpoints' directory
TRAIN_RESUME_TOL = 1e-6
TRAIN_CKPT = Path(__file__).resolve().parent / "build" / "train_ckpt"
#: B9's backward compare cases: ids a step of the train phase, and a few
GATHER_BWD_TS = (TRAIN_BATCH * TRAIN_SEQ, 4)
#: the study phase (the paper's sweep study): calls timed per (kernel, VL)
#: by measure_cuda (median, after its 2 warm-up calls), the latencies of
#: the user cube over h100_machine(), SpMV requests served on the
#: warm-started registry, and where its campaign store is written
STUDY_REPS = 10
STUDY_LATENCIES = (0, 128, 512)
STUDY_SPMV_REQUESTS = 32
#: calls of each kernel in the study's profiled window
STUDY_PROFILE_CALLS = 10
STUDY_STORE = Path(__file__).resolve().parent / "build" / "study" / \
    "BENCH_sweeps.json"
#: the sharded phase: a mesh naming the card SHARD_N times, big at these
#: k (row-sharded at 1 and 8, RHS-sharded at 32: a whole k tile a device),
#: SHARD_REQUESTS requests a (graph, op) through the service, and the
#: configurations of its k = 32 PageRank drives
SHARD_N = 4
SHARD_KS = (1, 8, 32)
SHARD_REQUESTS = 32
SHARD_DAMPINGS = [DAMPINGS[i % len(DAMPINGS)] for i in range(SHARD_REQUESTS)]
#: where B1 or B3 splits a bucket of either layout, the sharded result is
#: held to the unsharded one at this fraction of max|y| a column (fp64;
#: PageRank at PR_RTOL, float32 PageRank at SHARD_FP32_TOL): a split's
#: parts follow its bucket's width and slice count, and a shard packs its
#: rows into other slices (scripts/shard_split_rows.py counts the rows
#: whose split differs)
SHARD_TOL = 1e-10
#: float32 PageRank against its plain version: x max|rank| a column (the
#: port's fp32 scale, PERF.md section 2)
PR_FP32_TOL = 1e-4
#: float32 PageRank sharded against unsharded where a bucket splits: x
#: max|rank| a column (the same float32 sums grouped otherwise: 3.6e-8
#: measured on rmat15 at k = 32)
SHARD_FP32_TOL = 1e-6
#: the mesh phase: (arch, depth (None: the published one), (data, model)
#: meshes), each mesh naming the card data x model times; every run held
#: against the unsharded port with the same weights
MESH_RUNS = (("mixtral-8x7b", 2, ((1, 4), (2, 2), (1, 16))),
             ("deepseek-moe-16b", 2, ((1, 4),)),
             ("llama3.2-3b", None, ((1, 4),)))
#: decode steps of the mesh runs' logits check
MESH_DECODE_STEPS = 4
#: the mesh phase's logits against the unsharded port's, x max|logit|: fp32
#: partial products summed in another order (as LM_LOGIT_RTOL)
MESH_LOGIT_RTOL = 1e-4
#: the device a mesh phase's mesh names data x model times
MESH_DEVICE = "cuda:0"
#: B9's vocab-shard form: the tables split over a 4-way model axis
#: (mixtral's and llama's vocabularies and widths), its timing shard
MESH_GATHER_TABLES = {"mixtral-8x7b": (32_000, 4096), "llama3.2-3b": (128_256, 3072)}
MESH_GATHER_SHARDS = 4
#: the mesh-train phase: its main path (mamba2-2.7b at full width and
#: depth, trained TRAIN_STEPS steps of (TRAIN_BATCH, TRAIN_SEQ) tokens on
#: MESH_TRAIN_MESH naming the card four times), the 2-layer full-width
#: checks ((arch, meshes), each a step against the unsharded port on the
#: card) and their tolerances
MESH_TRAIN_ARCH = "mamba2-2.7b"
MESH_TRAIN_MESH = (1, 4)
MESH_TRAIN_CHECKS = (("mamba2-2.7b", ((1, 4), (2, 2))),
                     ("llama3.2-3b", ((1, 4),)),
                     ("deepseek-moe-16b", ((1, 4),)))
MESH_TRAIN_LOSS_RTOL = 1e-5
MESH_TRAIN_GRAD_TOL = 1e-4
MESH_TRAIN_NORM_RTOL = 1e-5
MESH_TRAIN_PARAM_TOL = 1e-6
#: the unsharded main path's step on the card (phase 14's train path as
#: PERF.md section 5 records it, NVIDIA H100 80GB HBM3, 700.00 W): ms,
#: tokens/s, peak GB
MESH_TRAIN_UNSHARDED = (889.0, 1155.3, 48.72)
#: B9's shard backward compare cases: ids a train step feeds a shard, and
#: fewer and more
SHARD_BWD_TS = (4, 512, TRAIN_BATCH * TRAIN_SEQ)
MESH_TRAIN_CKPT = Path(__file__).resolve().parent / "build" / "mesh_train_ckpt"
#: the mesh-families phase: the hybrid, enc-dec and vision archs at full
#: width on each mesh (naming the card data x model times), at full depth
#: but where MESH_FAMILY_DEPTH cuts it: two data replicas of vision's 47.85
#: GB do not fit one 80 GB card, so (2, 2) takes its first 20 layers (5
#: groups of 4 and their cross blocks, 26.0 GB a replica)
MESH_FAMILY_ARCHS = ("hymba-1.5b", "seamless-m4t-medium", "llama-3.2-vision-11b")
MESH_FAMILY_SHAPES = ((1, 4), (2, 2))
MESH_FAMILY_DEPTH = {("llama-3.2-vision-11b", (2, 2)): 20}
#: the unsharded readings of these archs (phase 13 as PERF.md section 5
#: records it, NVIDIA H100 80GB HBM3, 700.00 W): prefill ms (b = 1),
#: decode ms a step of LM_SLOTS, batcher tokens/s
MESH_FAMILY_PHASE13 = {"hymba-1.5b": (107.84, 110.52, 30.12),
                       "seamless-m4t-medium": (40.99, 31.95, 98.77),
                       "llama-3.2-vision-11b": (282.98, 93.08, 25.30)}
# phase 18 (bf16): the bf16 forms of B8 and B9 and the paths that run them
#: a bf16 scan's logits, card against CPU (both run B8's bf16 form: a y
#: element's rounding may flip where two float32 sums differ), and a bf16
#: step's gradients (D's is a bf16 sum of dy x in both, in another order)
BF16_LOGIT_RTOL = 1e-2
BF16_GRAD_TOL = 1e-2
#: the served bf16 model: requests of LM_PROMPT tokens, new tokens each
BF16_REQUESTS = 4
BF16_NEW_TOKENS = 8
BF16_TRAIN_STEPS = 2
#: B8 bf16 cases beyond phase 3's float32 ones: p past one 64-column
#: slice (y's partial sums through the float32 scratch), ragged
BF16_SSD_CASES = [(1, 128, 4, 80, 1, 32, 64, "float32"),
                  (2, 96, 6, 130, 2, 24, 32, "float32")]
#: B9 bf16 ids counts: phase 3's, the train step's (TRAIN_BATCH x
#: TRAIN_SEQ), and two slices of the backward's ids (its float32 carry)
BF16_GATHER_TS = tuple(sorted(set(GATHER_TS) | {TRAIN_BATCH * TRAIN_SEQ, 4096}))
#: a bf16 table of odd d (2 B rows: the forward's 2-byte vectors, the
#: backward's one-element ones)
BF16_ODD_TABLE = (4100, 2561)
#: the card's memory rate for bounds (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
#: where every tensor of the run lives: the card
DEVICE = "cuda"


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def b2_matches_b1(torch, sell_core, got, b1, cols) -> tuple[bool, str]:
    """B2 against B1: bit-equal where B1 walks every bucket with one thread
    a row (both then make the same multiply-adds in the same order); where
    B1 splits a bucket across threads it sums those rows in another order,
    so the two agree at the tolerance (1e-10 fp64, 1e-4 x max|y| fp32).
    Returns (ok, what was checked)."""
    if not sell_core.splits(cols):
        return torch.equal(got, b1), "bit-equal"
    fp64 = got.dtype == torch.float64
    tol = 1e-10 if fp64 else 1e-4 * float(b1.abs().max())
    err = max_err(got, b1)
    return err <= tol, f"split bucket: max abs err {err:.3e} <= {tol:.3e}"


def compare_kernel(torch, np, sell_core, F) -> float:
    """Phase 3: B1 vs spmm_sell_ref on the card; returns the fp64 max error."""
    operands = {
        "cage10": lambda dt: F.cage10_like(seed=0, dtype=dt),
        "rand4096": lambda dt: F.random_csr(4096, 4096, 8.0, seed=3,
                                            skew=1.2, dtype=dt),
    }
    rng = np.random.default_rng(1)
    worst64 = 0.0
    n_cases = 0
    for dt in (np.float64, np.float32):
        for name, make in operands.items():
            csr = make(dt)
            for c in (8, 32, 128, 256):
                slabs = F.csr_to_sell_slabs(csr, c=c)
                cols, vals, rows = slabs.to_device(DEVICE)
                # k_block 32: k_tile = pow2_ceil(k); the extra k=32 cases
                # reach every k_tile instantiation (1 .. 32)
                cases = [(1, 32), (8, 32), (32, 32), (32, 2), (32, 4),
                         (32, 16)]
                for k, kb in cases:
                    x = torch.from_numpy(
                        rng.standard_normal((csr.n_cols, k)).astype(dt)).to(DEVICE)
                    got = sell_core.spmm_sell(cols, vals, rows, x,
                                              n_rows=csr.n_rows, k_block=kb)
                    torch.cuda.synchronize()
                    want = sell_core.spmm_sell_ref(cols, vals, rows, x,
                                                   n_rows=csr.n_rows)
                    err = max_err(got, want)
                    if dt == np.float64:
                        tol = 1e-10
                        worst64 = max(worst64, err)
                    else:
                        tol = 1e-4 * float(want.abs().max())
                    if not err <= tol:
                        raise AssertionError(
                            f"B1 vs plain: {name} {np.dtype(dt).name} C={c} "
                            f"k={k} k_block={kb}: max abs err {err} > {tol}")
                    n_cases += 1
            phase("compare", f"{name} {np.dtype(dt).name}: C in (8, 32, 128, "
                  f"256) x (k, k_block) in {cases} within tolerance")
    phase("compare", f"{n_cases} cases ok; fp64 max abs err {worst64:.3e} "
          "(tol 1e-10), fp32 tol 1e-4 * max|y|")
    return worst64


def touched_columns(np, cols, n_cols: int) -> int:
    """Distinct columns among the stored entries (PAD excluded): the rows
    of X that Y = A @ X must read, which is what its bytes bound counts."""
    seen = np.zeros(n_cols + 1, bool)          # PAD (-1) lands in the extra slot
    seen[np.asarray(cols).reshape(-1)] = True
    return int(seen[:n_cols].sum())


def time_ms(torch, fn, flush, runs: int = 10, warmup: int = 2) -> float:
    """Median ms of ``fn`` over ``runs`` CUDA-event-timed calls, each after
    the L2 is flushed by overwriting a buffer twice its size."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bucket_ms(torch, sell_core, cols, vals, rows, x, n_rows, k_block, flush,
              runs: int = 5) -> list[tuple]:
    """The per-bucket breakdown of one spmm_sell call (X's k is already a
    whole number of k tiles): for each bucket (W, slices, threads a row,
    median ms of its launch alone)."""
    from repro_torch.core.autotune import spmm_split

    kt = sell_core.k_tile_for(x.shape[1], k_block)
    y = torch.zeros((n_rows + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    out = []
    for c, v, r in zip(cols, vals, rows):
        split = spmm_split(c.shape[1], c.shape[2], c.shape[0], kt,
                           x.element_size())
        ms = time_ms(torch, lambda: sell_core._launch_bucket(
            c, v, r, x, y, kt), flush, runs=runs, warmup=1)
        out.append((c.shape[1], c.shape[0], split.parts, ms))
    return out


def graph_compare_cases(G):
    """The compare phase's graphs: RMAT and uniform, at 2^12 nodes and at
    the prime 4093 (no slice or block divides it)."""
    return {
        "rmat4096": G.rmat_graph(4096, 16, seed=1),
        "uniform4096": G.random_graph(4096, 8, seed=2),
        "rmat4093": G.rmat_graph(4093, 8, seed=3),
        "uniform4093": G.random_graph(4093, 16, seed=4),
    }


def rel_err(got, want) -> float:
    """max |got - want| / |want| over entries with want != 0 (0 if none)."""
    nz = want != 0
    if not bool(nz.any()):
        return 0.0
    return float(((got - want).abs()[nz] / want.abs()[nz]).max())


def check_pr(name: str, got, want) -> float:
    """PageRank agreement at rtol PR_RTOL (only the summation order
    differs); returns the max abs error."""
    bad = (got - want).abs() > PR_RTOL * want.abs()
    if bool(bad.any()) or got.shape != want.shape:
        raise AssertionError(f"{name}: rel err {rel_err(got, want):.3e} > "
                             f"{PR_RTOL}")
    return max_err(got, want)


def compare_graph_kernels(torch, np, G, bfs_k, pr_k) -> dict:
    """Phase 3 (graphs): B3 (BFS and PageRank combines), B4 (its frontier
    pass and its walk, with the live widths handed in) and B5 against their
    plain versions on the card; BFS and the frontier exactly, PageRank at
    rtol 1e-10, two B5 calls bit-equal.  Returns the worst PageRank
    relative error per kernel."""
    from repro_torch.core.autotune import node_split
    from repro_torch.kernels import sell_core

    rng = np.random.default_rng(2)
    INF = G.INF
    worst = {"pagerank_step_sell": 0.0, "pagerank_step": 0.0}
    n_cases = 0
    split_ks = set()
    for name, g in graph_compare_cases(G).items():
        n = g.n_nodes
        rg = g.transpose()
        # ELLPACK: B4 (frontier pass and walk) over the levels from one
        # source, B5 on random input; uniform4093 also with PAD inside rows
        # and the warp of nodes 32 .. 63 all PAD (n is not a multiple of 32)
        adjs = {name: rg.adj}
        if name == "uniform4093":
            holey = rg.adj.copy()
            holey[rng.random(holey.shape) < 0.25] = G.PAD
            holey[32:64] = G.PAD
            adjs[f"{name} holey"] = holey
        for case, host in adjs.items():
            radj = G.EllpackGraph(adj=host, n_nodes=n).to_device(DEVICE)
            live = bfs_k.ell_live_widths(radj)
            if not np.array_equal(live.cpu().numpy(),
                                  live_count(np, host.T[None])):
                raise AssertionError(f"live widths != host count: {case}")
            dist = torch.full((n,), INF, dtype=torch.int32, device=DEVICE)
            dist[int(rng.integers(n))] = 0
            for level in range(1, 64):
                front = bfs_k.bfs_frontier(dist, level)
                got = bfs_k.bfs_step(radj, dist, level, live_width=live)
                want = bfs_k.bfs_step_ref(radj, dist, level)
                torch.cuda.synchronize()
                if not torch.equal(front, bfs_k.bfs_frontier_ref(dist, level)):
                    raise AssertionError(f"B4 frontier vs plain: {case} "
                                         f"level {level}")
                if not torch.equal(got, want):
                    raise AssertionError(f"B4 vs plain: {case} level {level}")
                n_cases += 1
                if torch.equal(got, dist):
                    break
                dist = got
            contrib = torch.from_numpy(rng.random(n)).to(DEVICE)
            consts = torch.from_numpy(rng.random(3)).to(DEVICE)
            got = pr_k.pagerank_step(radj, contrib, consts, live_width=live)
            want = pr_k.pagerank_step_ref(radj, contrib, consts)
            if not torch.equal(got, pr_k.pagerank_step(radj, contrib, consts,
                                                       live_width=live)):
                raise AssertionError(f"B5: two calls differ on {case}")
            check_pr(f"B5 vs plain: {case}", got, want)
            worst["pagerank_step"] = max(worst["pagerank_step"],
                                         rel_err(got, want))
            n_cases += 1
        # SELL: B3 with both combines, scalar state and k columns
        for c in (8, 32, 128, 256):
            adj, nodes = G.graph_to_sell_slabs(rg, c=c).to_device(DEVICE)
            for k in (None, 1, 3, 6, 8, 12, 32, 48):
                kt = sell_core.node_k_tile(1 if k is None else k)
                if any(node_split(a.shape[2], c, a.shape[0], kt, 8,
                                  "pagerank").parts > 1
                       for a in adj):
                    split_ks.add(1 if k is None else k)
                cols = 1 if k is None else k
                src = torch.from_numpy(rng.choice(n, cols, replace=False))
                shape = (n + 1,) if k is None else (n + 1, k)
                dist = torch.full(shape, INF, dtype=torch.int32, device=DEVICE)
                if k is None:
                    dist[int(src[0])] = 0
                else:
                    dist[src.to(DEVICE), torch.arange(k, device=DEVICE)] = 0
                for level in range(1, 5):
                    got = bfs_k.bfs_step_sell(adj, nodes, dist, level)
                    want = bfs_k.bfs_step_sell_ref(adj, nodes, dist, level)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"B3-BFS vs plain: {name} C={c} k={k} level {level}")
                    n_cases += 1
                    dist = got
                contrib = torch.from_numpy(rng.random(shape)).to(DEVICE)
                contrib[-1] = 0.0
                consts = torch.from_numpy(
                    rng.random((3,) if k is None else (3, k))).to(DEVICE)
                got = pr_k.pagerank_step_sell(adj, nodes, contrib, consts)
                want = pr_k.pagerank_step_sell_ref(adj, nodes, contrib, consts)
                check_pr(f"B3-PR vs plain: {name} C={c} k={k}", got, want)
                worst["pagerank_step_sell"] = max(
                    worst["pagerank_step_sell"], rel_err(got, want))
                n_cases += 1
        phase("compare", f"{name}: B4 (frontier and walk, every level) / B5 "
              f"on {len(adjs)} adjacency(ies) and B3 (BFS, PageRank) at C in "
              "(8, 32, 128, 256) x k in (scalar, 1, 3, 6, 8, 12, 32, 48) "
              "agree")
    if not {1, 3, 8, 32} <= split_ks:
        raise AssertionError(f"B3 split buckets compared only at k in "
                             f"{sorted(split_ks)}")
    phase("compare", f"{n_cases} graph cases ok, split buckets among them at "
          f"k in {sorted(split_ks)}; BFS exactly equal, PageRank "
          f"max rel err {max(worst.values()):.3e} (rtol {PR_RTOL})")
    return worst


def spmv_main_path(torch, np, F, sell_core, KernelRegistry, KernelService):
    """Phase 4: the SpMV path through the registry and the service."""
    t0 = time.perf_counter()
    cage = F.cage10_like(seed=0)
    big = F.random_csr(**BIG)
    phase("main", f"operands generated in {time.perf_counter() - t0:.1f} s: "
          f"cage10 {cage.n_rows}x{cage.n_cols} nnz {cage.nnz}; big "
          f"{big.n_rows}x{big.n_cols} nnz {big.nnz}")
    reg = KernelRegistry(device=DEVICE)
    operands = {"cage10": cage, "big": big}
    for name, csr in operands.items():
        op = reg.register_matrix(name, csr)
        t = op.tuned
        phase("main", f"registered {name}: C={t.c} sigma={t.sigma} "
              f"k_block={t.k_block} pad={op.pad_factor:.4f} buckets="
              f"{list(op.slabs.widths)} in {op.register_us / 1e6:.1f} s")
    svc = KernelService(reg, n_slots=N_SLOTS)
    rng = np.random.default_rng(0)
    xs = {name: [rng.standard_normal(csr.n_cols)
                 for _ in range(REQUESTS_PER_OPERAND)]
          for name, csr in operands.items()}
    torch.cuda.synchronize()
    sell_core.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    rids = {name: [svc.submit("spmv", name, x) for x in xs[name]]
            for name in operands}
    svc.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sell_core.KERNEL_LAUNCHES
    n_req = sum(len(v) for v in rids.values())
    stats = dict(svc.stats)
    phase("main", f"stats {json.dumps(stats)}")
    launch_wall = svc.metrics.get("launch_wall_us_spmv")
    phase("main", f"KERNEL_LAUNCHES={launches}; {n_req} requests in "
          f"{wall:.4f} s = {n_req / wall:.1f} requests/s; batched core calls "
          f"(kernels + sync) {launch_wall.total / 1e3:.3f} ms of it over "
          f"{launch_wall.count} groups")
    if launches <= 0:
        raise AssertionError("the main path launched kernel B1 no time")
    expected = sum(reg.get(n).launches * reg.get(n).slabs.n_buckets
                   for n in operands)
    if launches != expected:
        raise AssertionError(
            f"{launches} launches != one per bucket per group ({expected})")
    if stats["served"] != n_req or stats["failed"]:
        raise AssertionError(f"not every request was served: {stats}")
    for name, csr in operands.items():
        op = reg.get(name)
        arrs = op.device_arrays
        got = torch.stack([svc.poll(r) for r in rids[name]], dim=1)
        if tuple(got.shape) != (csr.n_rows, len(rids[name])) \
                or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: bad result shape/values")
        x_stack = torch.from_numpy(np.stack(xs[name], axis=1)).to(DEVICE)
        want = sell_core.spmm_sell_ref(arrs["cols"], arrs["vals"],
                                       arrs["rows"], x_stack, n_rows=csr.n_rows)
        err_ref = max_err(got, want)
        err_host = 0.0
        for i in range(4):
            host = torch.from_numpy(csr.matvec(xs[name][i]))
            err_host = max(err_host, max_err(got[:, i].cpu(), host))
        phase("main", f"{name}: {len(rids[name])} results vs plain on card "
              f"max abs err {err_ref:.3e}; 4 vs host CSR matvec "
              f"{err_host:.3e} (tol 1e-10)")
        if not (err_ref <= 1e-10 and err_host <= 1e-10):
            raise AssertionError(f"{name}: results disagree with references")
    return reg, big, launches


def max_level(np, dist) -> int:
    """The largest finite distance of a BFS result (levels run = this + 1)."""
    finite = dist[dist != np.iinfo(np.int32).max]
    return int(finite.max()) if finite.numel() else 0


def graph_main_path(torch, np, G, bfs_k, pr_k, ops, ExecSpec, KernelRegistry,
                    KernelService) -> dict:
    """Phase 5: the graph path through the registry, the service and ops."""
    from repro_torch.analysis import plan_bfs_ell

    graphs = {}
    for name, (make, kw) in GRAPHS.items():
        t0 = time.perf_counter()
        graphs[name] = getattr(G, make)(**kw)
        g = graphs[name]
        phase("graphs", f"{name}: {make}({kw}) in {time.perf_counter() - t0:.1f}"
              f" s: {g.n_nodes} nodes, {g.n_edges} edges, out-width {g.width}")
    reg = KernelRegistry(device=DEVICE)
    for name, g in graphs.items():
        op = reg.register_graph(name, g)
        t = op.tuned
        phase("graphs", f"registered {name}: C={t.c} sigma={t.sigma} pad="
              f"{op.pad_factor:.4f} buckets={list(op.slabs.widths)} slices="
              f"{[a.shape[0] for a in op.slabs.bucket_adj]} in "
              f"{op.register_us / 1e6:.1f} s")
    svc = KernelService(reg, n_slots=N_SLOTS)
    rng = np.random.default_rng(0)
    sources = {name: [int(s) for s in rng.integers(0, g.n_nodes,
                                                   REQUESTS_PER_OPERAND)]
               for name, g in graphs.items()}
    dampings = [DAMPINGS[i % len(DAMPINGS)]
                for i in range(REQUESTS_PER_OPERAND)]
    torch.cuda.synchronize()
    for key in bfs_k.KERNEL_LAUNCHES:
        bfs_k.KERNEL_LAUNCHES[key] = 0
    for key in pr_k.KERNEL_LAUNCHES:
        pr_k.KERNEL_LAUNCHES[key] = 0
    t0 = time.perf_counter()
    # bursts of 32 per (graph, op): the slot loop admits each as one group
    rids = {}
    for name in graphs:
        rids[name, "bfs"] = [svc.submit("bfs", name, None, source=s)
                             for s in sources[name]]
        rids[name, "pagerank"] = [
            svc.submit("pagerank", name, None, damping=d, iters=ITERS)
            for d in dampings]
    svc.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {"bfs_step_sell": bfs_k.KERNEL_LAUNCHES["bfs_step_sell"],
                "pagerank_step_sell": pr_k.KERNEL_LAUNCHES["pagerank_step_sell"]}
    stats = dict(svc.stats)
    n_req = sum(len(v) for v in rids.values())
    phase("graphs", f"stats {json.dumps(stats)}")
    walls = {op: svc.metrics.get(f"launch_wall_us_{op}")
             for op in ("bfs", "pagerank")}
    phase("graphs", f"KERNEL_LAUNCHES={launched}; {n_req} requests in "
          f"{wall:.4f} s = {n_req / wall:.1f} requests/s; batched drives "
          "(kernels + host loop + sync): " + ", ".join(
              f"{op} {h.total / 1e3:.3f} ms over {h.count} groups"
              for op, h in walls.items()))
    if stats["served"] != n_req or stats["failed"]:
        raise AssertionError(f"not every request was served: {stats}")
    if stats["groups"] != 2 * len(graphs) or \
            stats["max_group"] != REQUESTS_PER_OPERAND:
        raise AssertionError(f"requests did not coalesce into groups of "
                             f"{REQUESTS_PER_OPERAND}: {stats}")
    expected = {"bfs_step_sell": 0, "pagerank_step_sell": 0}
    results = {}
    for name, g in graphs.items():
        op = reg.get(name)
        arrs = op.device_arrays
        n = g.n_nodes
        nb = sum(1 for a in op.slabs.bucket_adj if a.shape[0])
        dist = torch.stack([svc.poll(r) for r in rids[name, "bfs"]], dim=1)
        rank = torch.stack([svc.poll(r) for r in rids[name, "pagerank"]],
                           dim=1)
        if tuple(dist.shape) != (n, REQUESTS_PER_OPERAND) or \
                dist.dtype != torch.int32 or tuple(rank.shape) != tuple(
                    dist.shape) or not bool(torch.isfinite(rank).all()):
            raise AssertionError(f"{name}: bad result shapes or values")
        expected["bfs_step_sell"] += nb * (max_level(np, dist) + 1)
        expected["pagerank_step_sell"] += nb * ITERS
        t0 = time.perf_counter()
        want = bfs_k.bfs_sell_ref(arrs["adj"], arrs["nodes"], n, sources[name])
        if not torch.equal(dist, want):
            raise AssertionError(f"{name}: BFS results != plain drive")
        want = pr_k.pagerank_sell_ref(arrs["adj"], arrs["nodes"],
                                      arrs["out_degree"], n, damping=dampings,
                                      iters=ITERS)
        err_plain = check_pr(f"{name}: PageRank vs plain drive", rank, want)
        t_plain = time.perf_counter() - t0
        t0 = time.perf_counter()
        host_bfs = {}
        for i in range(4):
            host_bfs[i] = G.bfs_reference(g, sources[name][i])
            if not np.array_equal(dist[:, i].cpu().numpy(), host_bfs[i]):
                raise AssertionError(f"{name}: BFS column {i} != bfs_reference")
        host_pr = {}
        err_host = 0.0
        # one column a graph: the host reference is the phase's slowest
        # check (rmat15's transpose is 5,754 wide)
        for i in range(GRAPH_HOST_PR_COLUMNS):
            host_pr[i] = torch.from_numpy(
                G.pagerank_reference(g, dampings[i], ITERS))
            err_host = max(err_host, check_pr(
                f"{name}: PageRank column {i} vs pagerank_reference",
                rank[:, i].cpu(), host_pr[i]))
        phase("graphs", f"{name}: 32 BFS results == plain drive on card, 4 == "
              f"bfs_reference; 32 PageRank results vs plain max abs err "
              f"{err_plain:.3e}, {GRAPH_HOST_PR_COLUMNS} vs pagerank_reference "
              f"{err_host:.3e} (rtol "
              f"{PR_RTOL}); max level {max_level(np, dist)}; plain drives "
              f"{t_plain:.1f} s, host references {time.perf_counter() - t0:.1f}"
              " s")
        results[name] = dict(sources=sources[name], host_bfs=host_bfs,
                             host_pr=host_pr)
    if launched != expected or min(launched.values()) <= 0:
        raise AssertionError(f"graph launches {launched} != buckets x steps "
                             f"{expected}")

    # ops on the ELLPACK layout (the default): kernels B4 and B5
    g = graphs["uniform21"]
    src = results["uniform21"]["sources"][0]
    spec = ExecSpec(layout="ell", device=DEVICE)
    torch.cuda.synchronize()
    bfs_k.KERNEL_LAUNCHES["bfs_step"] = 0
    bfs_k.KERNEL_LAUNCHES["bfs_frontier"] = 0
    pr_k.KERNEL_LAUNCHES["pagerank_step"] = 0
    t0 = time.perf_counter()
    d_ell = ops.bfs(g, src, spec=spec)
    r_ell = ops.pagerank(g, damping=DAMPINGS[0], iters=ITERS, spec=spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched.update(bfs_step=bfs_k.KERNEL_LAUNCHES["bfs_step"],
                    bfs_frontier=bfs_k.KERNEL_LAUNCHES["bfs_frontier"],
                    pagerank_step=pr_k.KERNEL_LAUNCHES["pagerank_step"])
    levels = max_level(np, d_ell) + 1
    want = {"bfs_step": levels, "bfs_frontier": levels,
            "pagerank_step": ITERS}
    if any(launched[k] != v for k, v in want.items()):
        raise AssertionError(f"ELLPACK launches {launched} != steps {want}")
    rg = g.transpose()
    radj = rg.to_device(DEVICE)
    deg = torch.from_numpy(g.out_degree.astype(np.float64)).to(DEVICE)
    if not torch.equal(d_ell, bfs_k.bfs_ref(radj, src)) or not np.array_equal(
            d_ell.cpu().numpy(), results["uniform21"]["host_bfs"][0]):
        raise AssertionError("ops.bfs (ell) != plain drive / bfs_reference")
    err_plain = check_pr("ops.pagerank (ell) vs plain", r_ell, pr_k.pagerank_ref(
        radj, deg, damping=DAMPINGS[0], iters=ITERS))
    err_host = check_pr("ops.pagerank (ell) vs pagerank_reference",
                        r_ell.cpu(), results["uniform21"]["host_pr"][0])
    phase("graphs", f"ops ell on uniform21 (ops wall {wall:.1f} s incl. "
          f"transpose + upload + live widths): KERNEL_LAUNCHES bfs_step="
          f"{launched['bfs_step']} bfs_frontier={launched['bfs_frontier']} "
          f"pagerank_step={launched['pagerank_step']}; "
          f"BFS == plain drive and bfs_reference; PageRank vs plain "
          f"{err_plain:.3e}, vs pagerank_reference {err_host:.3e}")
    # the adjacency and live widths ops cached for uniform21 (the timing
    # phase hands them to B4 / B5 as ops does)
    spec, device = ops._graph_spec(spec)
    _, ell_cached, _ = ops._prepared_graph(g, spec, device, plan_bfs_ell)
    return dict(graphs=graphs, reg=reg, launches=launched, results=results,
                reverse_u21=rg, deg=deg, ell_cached=ell_cached)


def profile_drives(torch, bfs_k, pr_k, gm: dict) -> None:
    """Where a graph drive's wall time goes: one drive per (graph, op) at
    the main path's width under ``torch.profiler``; the graph kernels'
    device time (events named ``*_step_kernel``) against the drive's host
    wall clock.  The rest is the host loop: per-level ``torch.equal`` syncs,
    the launches and the plain torch ops between them."""
    from torch.profiler import ProfilerActivity, profile

    dampings = [DAMPINGS[i % len(DAMPINGS)]
                for i in range(REQUESTS_PER_OPERAND)]
    # the first profiler run in a process pays the tracer's set-up
    # (seconds); pay it here, outside the measured drives
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=DEVICE).add_(1)
        torch.cuda.synchronize()
    for name in GRAPHS:
        arrs = gm["reg"].get(name).device_arrays
        n = gm["graphs"][name].n_nodes
        src = gm["results"][name]["sources"]
        for op, drive in (
                ("bfs", lambda: bfs_k.bfs_sell(arrs["adj"], arrs["nodes"], n,
                                               src)),
                ("pagerank", lambda: pr_k.pagerank_sell(
                    arrs["adj"], arrs["nodes"], arrs["out_degree"], n,
                    damping=dampings, iters=ITERS))):
            drive()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                drive()
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            kernel_ms = sum(e.device_time_total for e in prof.key_averages()
                            if "step_kernel" in e.key) / 1e3
            share = (f"{kernel_ms:.3f} ms ({100 * kernel_ms / wall_ms:.1f}%)"
                     if kernel_ms > 0 else "not measured (no device events)")
            phase("profile", f"{name} {op} drive, k={REQUESTS_PER_OPERAND}: "
                  f"wall {wall_ms:.3f} ms under the profiler; graph kernels "
                  f"{share}")


def profile_lm(torch, M, lm: dict, scope=contextlib.nullcontext,
               label: str = "") -> None:
    """Where the LM path's time goes: one b = 1 prefill (a batcher
    admission) and one decode step of LM_SLOTS sequences under
    ``torch.profiler`` (inside ``scope``: the MoE phase profiles its SELL
    combine this way, ``label`` naming it); the device's busy time (the
    device-side events' time, summed: one stream, so they do not overlap)
    against the host wall clock, and the kernels that take the most of
    it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, params = lm["cfg"], lm["params"]
    cases = (("prefill b=1", lm["prompts"][:1], M.prefill),
             (f"decode b={LM_SLOTS}", lm["prompts"][:LM_SLOTS, :1], M.decode_step))
    for what, toks, fn in cases:
        caches = M.init_caches(cfg, toks.shape[0], LM_PROMPT + LM_NEW_TOKENS,
                               dtype=torch.float32, device=DEVICE)
        batch = {"tokens": toks} if fn is M.prefill else toks

        def run():
            with scope():
                return fn(params, cfg, batch, caches)

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only (kernels, copies): a CPU op's device time
        # repeats its kernels'
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.device_time_total for e in dev) / 1e3
        top = sorted(dev, key=lambda e: e.device_time_total, reverse=True)[:5]
        share = (f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%)"
                 if busy > 0 else "device time not measured (no device events)")
        phase("profile", f"{cfg.name}{label} {what}: wall {wall_ms:.3f} ms under the "
              f"profiler; {share}; most device time: " + "; ".join(
                  f"{e.key[:48]} {e.device_time_total / 1e3:.3f} ms x{e.count}"
                  for e in top))


def sparse_reverse(torch, np, rg):
    """The reverse graph as a CSR matrix of ones on the card (the library
    yardstick's operand): row v holds v's in-neighbours."""
    mask = rg.adj != -1
    indptr = np.zeros(rg.n_nodes + 1, np.int64)
    np.cumsum(mask.sum(axis=1), out=indptr[1:])
    indices = rg.adj[mask].astype(np.int64)
    return torch.sparse_csr_tensor(
        torch.from_numpy(indptr), torch.from_numpy(indices),
        torch.ones(len(indices), dtype=torch.float64),
        size=(rg.n_nodes, rg.n_nodes)).to(DEVICE)


def node_bucket_ms(torch, launch, adj, nodes, flush) -> list[float]:
    """Median ms of each bucket's launch alone (the per-bucket breakdown of
    one graph step)."""
    return [time_ms(torch, lambda a=a.transpose(1, 2).contiguous(), m=m:
                    launch(a, m), flush, runs=5, warmup=1)
            for a, m in zip(adj, nodes)]


def time_graphs(torch, np, G, sell_core, bfs_k, pr_k, gm: dict,
                flush) -> dict:
    """Phase 6 (graphs): the graph kernels at the main path's shapes."""
    from repro_torch.core.autotune import node_split

    INF = G.INF
    records = {}
    lib_a = sparse_reverse(torch, np, gm["reverse_u21"])
    for name in ("uniform21", "rmat15"):
        main = name == "uniform21"
        g = gm["graphs"][name]
        op = gm["reg"].get(name)
        adj, nodes = op.device_arrays["adj"], op.device_arrays["nodes"]
        n, e = g.n_nodes, g.n_edges
        lanes = sum(a.shape[0] * a.shape[1] for a in op.slabs.bucket_adj)
        padded = op.slabs.padded_entries
        src = gm["results"][name]["sources"]
        deg = op.device_arrays["out_degree"]
        for k in (REQUESTS_PER_OPERAND, 1):
            # BFS: level 1 from the main path's sources (every node but the
            # sources searches its whole in-list, as the bound assumes)
            if k == 1:
                dist = torch.full((n + 1,), INF, dtype=torch.int32,
                                  device=DEVICE)
                dist[src[0]] = 0
            else:
                dist = torch.full((n + 1, k), INF, dtype=torch.int32,
                                  device=DEVICE)
                dist[torch.tensor(src[:k], device=DEVICE),
                     torch.arange(k, device=DEVICE)] = 0
            # PageRank: the first power step's contributions and constants
            cols = 1 if k == 1 else k
            rank0 = 1.0 / n
            c1 = torch.where(deg > 0, rank0 / torch.clamp(deg, min=1), 0.0)
            dang = float(torch.where(deg == 0, rank0, 0.0).sum()) / n
            d = torch.tensor([DAMPINGS[i % len(DAMPINGS)] for i in range(cols)],
                             dtype=torch.float64, device=DEVICE)
            consts = torch.stack([(1.0 - d) / n, d, torch.full_like(d, dang)])
            contrib = torch.cat([c1, c1.new_zeros(1)])
            if k == 1:
                consts = consts[:, 0].contiguous()
            else:
                contrib = contrib[:, None].expand(n + 1, k).contiguous()
            kt = sell_core.node_k_tile(cols)
            for kernel, fn, plain, bytes_least in (
                    ("bfs_step_sell",
                     lambda: bfs_k.bfs_step_sell(adj, nodes, dist, 1),
                     lambda: bfs_k.bfs_step_sell_ref(adj, nodes, dist, 1),
                     4 * e + 4 * n + 8 * n * cols),
                    ("pagerank_step_sell",
                     lambda: pr_k.pagerank_step_sell(adj, nodes, contrib,
                                                     consts),
                     lambda: pr_k.pagerank_step_sell_ref(adj, nodes, contrib,
                                                         consts),
                     4 * e + 4 * n + 16 * n * cols)):
                got, want = fn(), plain()
                torch.cuda.synchronize()
                if kernel == "bfs_step_sell":
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name} k={k}: B3-BFS != plain")
                    err = max_err(got.double(), want.double())
                    out = dist.clone()
                    launch = (lambda a, m: bfs_k._launch_sell_bucket(
                        a, m, dist, out, 1, kt))
                    ops_ms = e * cols / FP32_OPS * 1e3
                    lib_ms = None
                else:
                    err = check_pr(f"{name} k={k}: B3-PR vs plain", got, want)
                    out = torch.zeros_like(contrib)
                    launch = (lambda a, m: pr_k._launch_sell_bucket(
                        a, m, contrib, consts, out, kt))
                    ops_ms = e * cols / FP64_FLOPS * 1e3
                    lib_ms = None
                    if main:
                        xk = contrib[:n].reshape(n, cols)

                        def library():
                            return torch.sparse.mm(lib_a, xk)

                        pulled = library()
                        cm = consts.reshape(3, cols)
                        check_pr(f"{name} k={k}: B3-PR vs torch.sparse.mm",
                                 got[:n].reshape(n, cols),
                                 cm[0] + cm[1] * (pulled + cm[2]))
                        lib_ms = time_ms(torch, library, flush)
                per_bucket = node_bucket_ms(torch, launch, adj, nodes, flush)
                itemsize = 4 if kernel == "bfs_step_sell" else 8
                splits = [node_split(a.shape[2], a.shape[1], a.shape[0], kt,
                                     itemsize, "bfs" if itemsize == 4
                                     else "pagerank") for a in adj]
                phase("timing", f"{name} k={k} {kernel} per bucket (W: slices, "
                      "lanes a node x parts, ms): " + ", ".join(
                          f"{a.shape[2]}: {a.shape[0]}, {sp.group}x"
                          f"{sp.parts}, {t:.4f}"
                          for a, sp, t in zip(adj, splits, per_bucket)))
                if not main:
                    continue
                ms = time_ms(torch, fn, flush)
                plain_ms = time_ms(torch, plain, flush)
                state = 8 if kernel == "bfs_step_sell" else 16
                bytes_ms = bytes_least / HBM_BYTES_PER_S * 1e3
                padded_ms = (4 * padded + 4 * lanes + state * n * cols) \
                    / HBM_BYTES_PER_S * 1e3
                # the schedule's own gather: each stored edge reads its
                # neighbour's state row (k columns) once
                gather_ms = e * cols * itemsize / HBM_BYTES_PER_S * 1e3
                rec = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=max(bytes_ms, ops_ms),
                           bound_by="bytes" if bytes_ms >= ops_ms
                           else "operations",
                           max_abs_err=err, bucket_ms=per_bucket,
                           buckets=[dict(width=a.shape[2], slices=a.shape[0],
                                         group=sp.group, parts=sp.parts,
                                         ms=t) for a, sp, t in
                                    zip(adj, splits, per_bucket)])
                records.setdefault(kernel, {})[k] = rec
                phase("timing", f"{name} k={k}: {kernel} {ms:.4f} ms | bound "
                      f"{bytes_ms:.4f} ms (bytes; ops {ops_ms:.4f}) | gather "
                      f"bytes {e * cols * itemsize} B = {gather_ms:.4f} ms | "
                      f"padded-slab bytes bound {padded_ms:.4f} ms | plain "
                      f"{plain_ms:.4f} ms | library " + (
                          f"torch.sparse.mm {lib_ms:.4f} ms" if lib_ms
                          is not None else "none (no single PyTorch call "
                          "computes a BFS level)") +
                      f" | max abs err vs plain {err:.3e}")
    # ELLPACK kernels B4 / B5 on uniform21, one state column, with the
    # adjacency and live widths ops cached for it (as ops hands them in)
    g = gm["graphs"]["uniform21"]
    n, e = g.n_nodes, g.n_edges
    radj, live = gm["ell_cached"]
    deg = gm["deg"]
    width = radj.shape[1]
    live_ms = time_ms(torch, lambda: bfs_k.ell_live_widths(radj), flush)
    walked = int((live.cpu().numpy().astype(np.int64) * 32).sum())
    phase("timing", f"uniform21 live widths: ell_live_widths {live_ms:.4f} ms"
          " (built once per graph and device by ops, outside the timed "
          f"calls); slots walked {walked} of {n * width} stored "
          f"({walked / (n * width):.3f}), {e} of them edges")
    src = gm["results"]["uniform21"]["sources"][0]
    dist = torch.full((n,), INF, dtype=torch.int32, device=DEVICE)
    dist[src] = 0
    rank0 = 1.0 / n
    contrib = torch.where(deg > 0, rank0 / torch.clamp(deg, min=1), 0.0)
    dang = float(torch.where(deg == 0, rank0, 0.0).sum()) / n
    consts = torch.tensor([(1.0 - DAMPINGS[0]) / n, DAMPINGS[0], dang],
                          dtype=torch.float64, device=DEVICE)
    words = -(-n // 32)
    for kernel, fn, plain, bytes_least, ops_ms in (
            ("bfs_frontier", lambda: bfs_k.bfs_frontier(dist, 1),
             lambda: bfs_k.bfs_frontier_ref(dist, 1), 4 * n + 4 * words,
             n / FP32_OPS * 1e3),
            ("bfs_step", lambda: bfs_k.bfs_step(radj, dist, 1,
                                                live_width=live),
             lambda: bfs_k.bfs_step_ref(radj, dist, 1), 4 * e + 8 * n,
             e / FP32_OPS * 1e3),
            ("pagerank_step", lambda: pr_k.pagerank_step(
                radj, contrib, consts, live_width=live),
             lambda: pr_k.pagerank_step_ref(radj, contrib, consts),
             4 * e + 16 * n, e / FP64_FLOPS * 1e3)):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        lib_ms = None
        if kernel != "pagerank_step":
            if not torch.equal(got, want):
                raise AssertionError(f"{kernel} != plain at the main shape")
            err = max_err(got.double(), want.double())
        else:
            err = check_pr("B5 vs plain at the main shape", got, want)

            def library():
                return torch.sparse.mm(lib_a, contrib[:, None])

            check_pr("B5 vs torch.sparse.mm", got,
                     consts[0] + consts[1] * (library()[:, 0] + consts[2]))
            lib_ms = time_ms(torch, library, flush)
        ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, plain, flush)
        bytes_ms = bytes_least / HBM_BYTES_PER_S * 1e3
        records[kernel] = {1: dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            max_abs_err=err)}
        state = 16 if kernel == "pagerank_step" else 8
        walk_ms = (4 * walked + state * n) / HBM_BYTES_PER_S * 1e3
        goal = {"bfs_step": 0.20, "pagerank_step": 0.30}.get(kernel)
        phase("timing", f"uniform21 k=1: {kernel} {ms:.4f} ms" + (
            f" (goal <= {goal}: {'met' if ms <= goal else 'missed'})"
            if goal else "") + f" | bound {bytes_ms:.4f} ms (bytes; ops "
            f"{ops_ms:.4f})" + ("" if kernel == "bfs_frontier" else
                                f" | ids to the live widths {walk_ms:.4f} "
                                f"ms | padded-ELLPACK (width {width}) "
                                f"{(4 * n * width + state * n) / HBM_BYTES_PER_S * 1e3:.4f} ms")
            + f" | plain {plain_ms:.4f} ms | library " + (
                f"torch.sparse.mm {lib_ms:.4f} ms" if lib_ms is not None
                else "none (no single PyTorch call computes it)")
            + f" | max abs err vs plain {err:.3e}")
    # B4 at each level of the ops.bfs drive from the same source (the
    # whole drive's kernel time is their sum), the frontier pass beside it
    levels, d = [], dist
    for level in range(1, n + 1):
        new = bfs_k.bfs_step(radj, d, level, live_width=live)
        levels.append((level, d))
        if torch.equal(new, d):
            break
        d = new
    by_level = [(level, time_ms(torch, lambda d=d, lv=level: bfs_k.bfs_step(
        radj, d, lv, live_width=live), flush), time_ms(
            torch, lambda d=d, lv=level: bfs_k.bfs_frontier(d, lv), flush))
        for level, d in levels]
    phase("timing", "uniform21 B4 by level of the drive from source "
          f"{src} (level: bfs_step ms incl. its frontier pass, frontier ms): "
          + ", ".join(f"{lv}: {t:.4f}, {f:.4f}" for lv, t, f in by_level)
          + f"; sum {sum(t for _, t, _ in by_level):.4f} ms over "
          f"{len(by_level)} levels")
    records["bfs_step"][1]["by_level_ms"] = [t for _, t, _ in by_level]
    # B5's id-free reading: every id u taken mod 2048 (PAD stays PAD), so
    # the walk is the same and the gathers hit a 16 KB range; the gap to
    # B5 is the time its gathers take through the L2
    store = radj.t()
    near = torch.where(store != G.PAD, store % 2048, store).t()
    idfree_ms = time_ms(torch, lambda: pr_k.pagerank_step(
        near, contrib, consts, live_width=live), flush)
    pr_ms = records["pagerank_step"][1]["ms"]
    phase("timing", f"uniform21 B5 id-free reading (ids mod 2048): "
          f"{idfree_ms:.4f} ms against B5 {pr_ms:.4f} ms: the gathers "
          f"through the L2 take {pr_ms - idfree_ms:.4f} ms; B5's bound "
          f"{records['pagerank_step'][1]['bound_ms']:.4f} ms")
    return records


def time_spmv(torch, np, sell_core, op, big, launches, flush) -> dict:
    """Phase 6 (SpMV): B1 at the main path's shapes."""
    cols, vals, rows = (op.device_arrays[k] for k in ("cols", "vals", "rows"))
    # bytes the padded SELL slabs hold (the layout's cost, printed beside
    # the bound); the bound itself counts only what Y = A @ X must move
    slab_bytes = sum(t.numel() * t.element_size()
                     for t in (*cols, *vals, *rows))
    elem = vals[0].element_size()
    x_rows = touched_columns(np, big.indices, big.n_cols)
    a_lib = torch.sparse_csr_tensor(
        torch.from_numpy(big.indptr), torch.from_numpy(big.indices.astype(np.int64)),
        torch.from_numpy(big.data), size=(big.n_rows, big.n_cols)).to(DEVICE)
    rng = np.random.default_rng(1)
    records = {}
    for k in (1, REQUESTS_PER_OPERAND):
        x = torch.from_numpy(rng.standard_normal((big.n_cols, k))).to(DEVICE)
        kb = op.tuned.k_block

        def kernel():
            return sell_core.spmm_sell(cols, vals, rows, x, n_rows=big.n_rows,
                                       k_block=kb)

        def plain():
            return sell_core.spmm_sell_ref(cols, vals, rows, x,
                                           n_rows=big.n_rows)

        def library():
            return torch.sparse.mm(a_lib, x)

        y_k, y_p, y_l = kernel(), plain(), library()
        torch.cuda.synchronize()
        err = max_err(y_k, y_p)
        err_lib = max_err(y_k, y_l)
        if not (err <= 1e-10 and err_lib <= 1e-10):
            raise AssertionError(f"k={k}: kernel vs plain {err}, vs library "
                                 f"{err_lib}")
        ms = time_ms(torch, kernel, flush)
        plain_ms = time_ms(torch, plain, flush)
        lib_ms = time_ms(torch, library, flush)
        xy_bytes = elem * k * (x_rows + big.n_rows)
        # each stored entry (int32 column + value) once, each row's id
        # once, the rows of X a stored column names read once, Y written
        # once
        bytes_ms = (big.nnz * (4 + elem) + 4 * big.n_rows + xy_bytes) \
            / HBM_BYTES_PER_S * 1e3
        padded_ms = (slab_bytes + xy_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * big.nnz * k / FP64_FLOPS * 1e3
        records[k] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=max(bytes_ms, ops_ms),
                          bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                          max_abs_err=err)
        buckets = bucket_ms(torch, sell_core, cols, vals, rows, x,
                            big.n_rows, kb, flush)
        records[k]["buckets"] = [dict(width=w, slices=s, parts=p, ms=t)
                                 for w, s, p, t in buckets]
        phase("timing", f"big k={k} per bucket (W: slices, threads a row, "
              "ms): " + ", ".join(f"{w}: {s}, x{p}, {t:.4f}"
                                  for w, s, p, t in buckets))
        wide = [b for b in buckets if b[2] > 1]
        phase("timing", f"big k={k}: the split buckets (W >= "
              f"{min((b[0] for b in wide), default=0)}) take "
              f"{sum(b[3] for b in wide):.4f} ms of the buckets' "
              f"{sum(b[3] for b in buckets):.4f} ms launched alone")
        phase("timing", f"big k={k}: B1 {ms:.4f} ms | bound {bytes_ms:.4f} ms "
              f"(bytes; ops {ops_ms:.4f}) | padded-slab bytes bound "
              f"{padded_ms:.4f} ms | plain {plain_ms:.4f} ms | "
              f"torch.sparse.mm {lib_ms:.4f} ms | max abs err vs plain "
              f"{err:.3e}, vs sparse.mm {err_lib:.3e} | slab bytes "
              f"{slab_bytes}")
    main_k = REQUESTS_PER_OPERAND
    return {"name": "spmm_sell", "route": "cuda",
            "source": "src/repro_torch/csrc/spmm_sell.cu",
            "replaces": "src/repro/kernels/sell_core.py:93",
            "launches": launches, **records[main_k],
            "shape": f"{big.n_rows}x{big.n_cols} nnz {big.nnz} fp64, k={main_k}",
            "k1": records[1]}


def graph_records(gm: dict, records: dict) -> list[dict]:
    """The graph kernels' entries of the kernels line (B3 at k = 32 with
    its k = 1 record beside it; B4, its frontier pass and B5 at k = 1)."""
    g = gm["graphs"]["uniform21"]
    shape = f"uniform21 {g.n_nodes} nodes {g.n_edges} edges"
    out = []
    for name, replaces, main_k in (
            ("bfs_step_sell", "src/repro/kernels/bfs.py:87",
             REQUESTS_PER_OPERAND),
            ("pagerank_step_sell", "src/repro/kernels/pagerank.py:81",
             REQUESTS_PER_OPERAND),
            ("bfs_step", "src/repro/kernels/bfs.py:37", 1),
            ("bfs_frontier", "src/repro/kernels/bfs.py:37", 1),
            ("pagerank_step", "src/repro/kernels/pagerank.py:33", 1)):
        rec = dict(records[name][main_k])
        rec.pop("bucket_ms", None)
        rec.pop("by_level_ms", None)
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/csrc/graph_step.cu",
                 "replaces": replaces, "launches": gm["launches"][name],
                 **rec, "shape": f"{shape}, k={main_k}"
                 + (", level 1" if "bfs" in name else ", power step 1")
                 + (" (B4's frontier pass and walk)" if name == "bfs_step"
                    else " (B4's frontier pass)" if name == "bfs_frontier"
                    else "")}
        if main_k != 1:
            k1 = dict(records[name][1])
            k1.pop("bucket_ms", None)
            entry["k1"] = k1
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# FFT (B7) and ELLPACK SpMV (B6)
# ---------------------------------------------------------------------------


def fft_tol(np, dtype, n, scale) -> tuple[float, float]:
    """(rtol, atol) of B7 for a spectrum whose largest component is
    ``scale``: fp64 the reference's own against numpy, 1e-9 / 1e-9 n; fp32
    1e-3 / 1e-5 x scale (FMA contraction changes ulps per stage, and the
    error grows with the spectrum's size, not with n)."""
    if dtype == np.float64:
        return 1e-9, 1e-9 * n
    return 1e-3, 1e-5 * scale


def check_fft(torch, np, name, got, want, n, dtype) -> float:
    """Both planes of a spectrum within the FFT tolerance; returns the max
    abs error."""
    want = [torch.as_tensor(w, device=g.device, dtype=g.dtype)
            for g, w in zip(got, want)]
    scale = max(float(w.abs().max()) if w.numel() else 0.0 for w in want)
    rtol, atol = fft_tol(np, dtype, n, scale)
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: bad spectrum shape/values")
        if not bool(((g - w).abs() <= atol + rtol * w.abs()).all()):
            raise AssertionError(f"{name}: max abs err {max_err(g, w)} over "
                                 f"rtol {rtol} / atol {atol}")
        err = max(err, max_err(g, w))
    return err


def fft_inputs(torch, np, fft_k, batch, n, dtype, seed):
    rng = np.random.default_rng(seed)
    re, im = (torch.from_numpy(rng.standard_normal((batch, n)).astype(dtype))
              .to(DEVICE) for _ in range(2))
    wre, wim = (torch.from_numpy(w).to(DEVICE)
                for w in fft_k.fft_twiddles(n, dtype))
    return re, im, wre, wim


def compare_fft(torch, np, fft_k) -> dict:
    """Phase 3 (FFT): B7 against fft_stockham_ref on the card, both forms
    on both sides of the shared-memory limit, then the two-pass form at
    other tiles than the tuner's (bit-equal: a tile only groups
    sub-signals); returns the worst error per dtype."""
    worst = {}
    n_cases = 0
    for dtype in (np.float64, np.float32):
        for n in FFT_COMPARE_NS:
            forms = set()
            for batch in FFT_COMPARE_BATCHES:
                args = fft_inputs(torch, np, fft_k, batch, n, dtype,
                                  seed=n + batch)
                before = dict(fft_k.KERNEL_LAUNCHES)
                got = fft_k.fft_stockham(*args, b_block=8)
                torch.cuda.synchronize()
                forms |= {k for k, v in fft_k.KERNEL_LAUNCHES.items()
                          if v != before[k]}
                want = fft_k.fft_stockham_ref(*args)
                err = check_fft(torch, np, f"B7 vs plain: n={n} batch={batch}"
                                f" {np.dtype(dtype).name}", got, want, n,
                                dtype)
                re, im, wre, wim = args
                if batch == FFT_COMPARE_BATCHES[1] and n > 2 and re.is_cuda:
                    # the kernel reads row 0 of the twiddle tables only:
                    # NaN in every other row changes no bit
                    wre, wim = wre.clone(), wim.clone()
                    wre[1:], wim[1:] = float("nan"), float("nan")
                    again = fft_k.fft_stockham(re, im, wre, wim, b_block=8)
                    if not all(torch.equal(a, g) for a, g in zip(again, got)):
                        raise AssertionError(f"B7 n={n}: reads a twiddle row "
                                             "past row 0")
                key = np.dtype(dtype).name
                worst[key] = max(worst.get(key, 0.0), err)
                n_cases += 1
            phase("compare", f"B7 n={n} {np.dtype(dtype).name} batches "
                  f"{FFT_COMPARE_BATCHES}: {sorted(forms)} within tolerance")
    from repro_torch.core.autotune import fft_two_pass

    n = FFT_PLANS["fft131072"][0]
    for dtype in (np.float64, np.float32):
        re, im, wre, wim = fft_inputs(torch, np, fft_k, 3, n, dtype, seed=5)
        n1, _, tile_a, tile_b = fft_two_pass(n, re.element_size())
        outs = {}
        for tiles in ((1, 1), (2, 4), (4, 2), (tile_a, tile_b)):
            scratch = (torch.empty_like(re), torch.empty_like(im))
            out = (torch.empty_like(re), torch.empty_like(im))
            fft_k._launch_pass(True, re, im, wre, wim, *scratch, n1, tiles[0])
            fft_k._launch_pass(False, *scratch, wre, wim, *out, n1, tiles[1])
            outs[tiles] = out
        torch.cuda.synchronize()
        base = outs[(tile_a, tile_b)]
        if not all(torch.equal(a, b) for o in outs.values()
                   for a, b in zip(o, base)):
            raise AssertionError(f"B7 two-pass n={n} {np.dtype(dtype).name}: "
                                 "the tiles change the result")
        check_fft(torch, np, f"B7 two-pass tiles n={n}", base,
                  fft_k.fft_stockham_ref(re, im, wre, wim), n, dtype)
        n_cases += len(outs)
        phase("compare", f"B7 two-pass n={n} {np.dtype(dtype).name} (n1 "
              f"{n1}): tiles {sorted(outs)} bit-equal, within tolerance")
    phase("compare", f"{n_cases} B7 cases ok; max abs err {worst} (rtol / "
          "atol: fp64 1e-9 / 1e-9 n, fp32 1e-3 / 1e-5 max|spectrum|); both "
          "forms read row 0 of the twiddle tables only (NaN rows 1.. change "
          "no bit)")
    return worst


def live_count(np, cols):
    """B6's live widths counted on the host: per 32 consecutive rows (row r
    is lane r % C of slice r // C), 1 + the last slot holding a column."""
    slots = np.arange(1, cols.shape[1] + 1)[None, :, None]
    rows = np.where(cols != -1, slots, 0).max(axis=1).reshape(-1)
    rows = np.pad(rows, (0, -len(rows) % 32))
    return rows.reshape(-1, 32).max(axis=1)


def holey_ellpack(np, F, ell, seed: int):
    """``ell`` with PAD punched inside rows (a quarter of the slots) and the
    rows 32 .. 63 all PAD (one warp with nothing to walk)."""
    rng = np.random.default_rng(seed)
    cols, vals = ell.cols.copy(), ell.vals.copy()
    holes = rng.random(cols.shape) < 0.25
    cols[holes] = F.PAD
    rows = cols.transpose(0, 2, 1).reshape(-1, cols.shape[1])
    rows[32:64] = F.PAD
    cols = np.ascontiguousarray(rows.reshape(
        cols.shape[0], cols.shape[2], cols.shape[1]).transpose(0, 2, 1))
    vals = np.where(cols == F.PAD, 0, vals).astype(vals.dtype)
    return F.EllpackMatrix(cols=cols, vals=vals, n_rows=ell.n_rows,
                           n_cols=ell.n_cols, nnz=int((cols != F.PAD).sum()))


def ell_tiles(k: int, itemsize: int) -> list:
    """B6's k-form launches for k columns of X (16 B aligned)."""
    from repro_torch.core import autotune

    return autotune.ell_k_tiles(k, autotune.ell_vec(k, itemsize))


def compare_spmv_ell(torch, np, F, spmv_k) -> float:
    """Phase 3 (ELLPACK): B6 against spmv_ell_ref on the card, then its
    k-column form at ELL_COMPARE_KS against k one-column launches
    (torch.equal) and spmm_ell_ref, on the packed operands and on copies
    with PAD inside rows and a warp of all-PAD rows; the live widths against
    a host count.  Returns the fp64 max error."""
    operands = {
        "cage10": lambda dt: F.cage10_like(seed=0, dtype=dt),
        "rand4093": lambda dt: F.random_csr(4093, 4093, 8.0, seed=3,
                                            skew=1.2, dtype=dt),
    }
    rng = np.random.default_rng(5)
    worst64 = 0.0
    n_cases = n_k = 0
    for dt in (np.float64, np.float32):
        for name, make in operands.items():
            csr = make(dt)
            x = torch.from_numpy(
                rng.standard_normal(csr.n_cols).astype(dt)).to(DEVICE)
            X = torch.from_numpy(rng.standard_normal(
                (csr.n_cols, max(ELL_COMPARE_KS))).astype(dt)).to(DEVICE)
            for c in (8, 16, 32, 64, 128, 256):
                packed = F.csr_to_ellpack(csr, c=c)
                for ell in (packed, holey_ellpack(np, F, packed, c)):
                    cols, vals = ell.to_device(DEVICE)
                    live = spmv_k.live_widths(cols)
                    if not np.array_equal(live.cpu().numpy(),
                                          live_count(np, ell.cols)):
                        raise AssertionError(f"B6 live widths: {name} C={c}")
                    got = spmv_k.spmv_ell(cols, vals, x, live_width=live)
                    torch.cuda.synchronize()
                    want = spmv_k.spmv_ell_ref(cols, vals, x)
                    err = max_err(got, want)
                    if dt == np.float64:
                        tol = 1e-10
                        worst64 = max(worst64, err)
                    else:
                        tol = 1e-4 * float(want.abs().max())
                    if not err <= tol:
                        raise AssertionError(
                            f"B6 vs plain: {name} {np.dtype(dt).name} C={c}: "
                            f"max abs err {err} > {tol}")
                    n_cases += 1
                    if c not in (32, 256):
                        continue
                    for k in ELL_COMPARE_KS:
                        xk = X[:, :k].contiguous()
                        gk = spmv_k.spmm_ell(cols, vals, xk, live_width=live)
                        cbc = torch.stack([spmv_k.spmv_ell(
                            cols, vals, xk[:, i].contiguous(),
                            live_width=live) for i in range(k)], dim=1)
                        torch.cuda.synchronize()
                        if not torch.equal(gk, cbc):
                            raise AssertionError(
                                f"B6 k form != column by column: {name} "
                                f"{np.dtype(dt).name} C={c} k={k}")
                        wk = spmv_k.spmm_ell_ref(cols, vals, xk)
                        err = max_err(gk, wk)
                        tol = 1e-10 if dt == np.float64 else \
                            1e-4 * float(wk.abs().max())
                        if dt == np.float64:
                            worst64 = max(worst64, err)
                        if not err <= tol:
                            raise AssertionError(
                                f"B6 k form vs plain: {name} C={c} k={k}: "
                                f"{err} > {tol}")
                        n_k += 1
            phase("compare", f"B6 {name} {np.dtype(dt).name}: C in (8, 16, "
                  "32, 64, 128, 256), packed and with PAD inside rows and an all-PAD "
                  "warp, within tolerance; live widths equal the host count")
    phase("compare", f"{n_cases} B6 cases ok; {n_k} k-form cases (k in "
          f"{ELL_COMPARE_KS}) torch.equal to the column-by-column launches "
          f"and within tolerance of spmm_ell_ref; fp64 max abs err "
          f"{worst64:.3e} (tol 1e-10), fp32 tol 1e-4 * max|y|")
    return worst64


def fft_main_path(torch, np, F, fft_k, sell_core, KernelRegistry,
                  KernelService) -> dict:
    """Phase 6: the FFT path through the registry and the service, FFT
    requests of two plans mixed with SpMV requests in one drain."""
    reg = KernelRegistry(device=DEVICE)
    for name, (n, _) in FFT_PLANS.items():
        op = reg.register_fft(name, n)
        phase("fft", f"registered {name}: n={n}, plan "
              f"{op.plans['fft'].blocks[0].label} x "
              f"{op.plans['fft'].n_launches} in {op.register_us / 1e3:.1f} ms")
    cage = F.cage10_like(seed=0)
    reg.register_matrix("cage10", cage)
    svc = KernelService(reg, n_slots=N_SLOTS)
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    sigs = {name: [rng.standard_normal((rows, n))
                   for _ in range(FFT_REQUESTS_PER_PLAN)]
            for name, (n, rows) in FFT_PLANS.items()}
    xs = [rng.standard_normal(cage.n_cols) for _ in range(FFT_SPMV_REQUESTS)]
    phase("fft", f"payloads generated in {time.perf_counter() - t0:.1f} s")
    # mixed as examples/serve_kernels.py mixes its traffic: a repeating
    # pattern of the two plans and SpMV (2 + 2 + 1 per round of five)
    order = []
    for i in range(FFT_SPMV_REQUESTS):
        order += [("fft2048", 2 * i), ("fft131072", 2 * i), ("spmv", i),
                  ("fft2048", 2 * i + 1), ("fft131072", 2 * i + 1)]
    torch.cuda.synchronize()
    for key in fft_k.KERNEL_LAUNCHES:
        fft_k.KERNEL_LAUNCHES[key] = 0
    sell_core.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    rids = {}
    for what, i in order:
        if what == "spmv":
            rids[what, i] = svc.submit("spmv", "cage10", xs[i])
        else:
            rids[what, i] = svc.submit("fft", what, sigs[what][i])
    svc.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(fft_k.KERNEL_LAUNCHES)
    b1 = sell_core.KERNEL_LAUNCHES
    stats = dict(svc.stats)
    n_req = len(order)
    phase("fft", f"stats {json.dumps(stats)}")
    walls = svc.metrics.get("launch_wall_us_fft")
    phase("fft", f"fft.KERNEL_LAUNCHES={launched}, sell_core.KERNEL_LAUNCHES="
          f"{b1}; {n_req} requests in {wall:.4f} s = {n_req / wall:.1f} "
          f"requests/s over {stats['groups']} groups; fft calls (kernels + "
          f"sync) {walls.total / 1e3:.3f} ms over {walls.count} groups")
    if stats["served"] != n_req or stats["failed"]:
        raise AssertionError(f"not every request was served: {stats}")
    groups = {name: reg.get(name).launches for name in FFT_PLANS}
    want = {"fft_stockham_block": groups["fft2048"],
            "fft_stockham_two_pass": 2 * groups["fft131072"]}
    if launched != want or min(launched.values()) <= 0:
        raise AssertionError(f"fft launches {launched} != groups x launches "
                             f"per call {want}")
    cage_op = reg.get("cage10")
    if b1 != cage_op.launches * cage_op.slabs.n_buckets or b1 <= 0:
        raise AssertionError(f"B1 launches {b1} != buckets x groups")
    for name, (n, rows) in FFT_PLANS.items():
        arrs = reg.get(name).device_arrays
        got = [torch.cat([svc.poll(rids[name, i])[p]
                          for i in range(FFT_REQUESTS_PER_PLAN)])
               for p in (0, 1)]
        batch = torch.from_numpy(np.concatenate(sigs[name])).to(DEVICE)
        plain = fft_k.fft_stockham_ref(batch, torch.zeros_like(batch),
                                       arrs["wre"], arrs["wim"])
        err_plain = check_fft(torch, np, f"{name} vs plain", got, plain, n,
                              np.float64)
        err_host = 0.0
        for i in range(4):
            spec = np.fft.fft(sigs[name][i], axis=-1)
            err_host = max(err_host, check_fft(
                torch, np, f"{name} request {i} vs np.fft.fft",
                [g.cpu() for g in svc.poll(rids[name, i])],
                (spec.real, spec.imag), n, np.float64))
        phase("fft", f"{name}: {FFT_REQUESTS_PER_PLAN} results "
              f"({FFT_REQUESTS_PER_PLAN * rows} signals of {n}) vs plain on "
              f"card max abs err {err_plain:.3e}, 4 vs np.fft.fft "
              f"{err_host:.3e} (rtol 1e-9, atol 1e-9 n)")
    got = torch.stack([svc.poll(rids["spmv", i])
                       for i in range(FFT_SPMV_REQUESTS)], dim=1)
    arrs = cage_op.device_arrays
    x_stack = torch.from_numpy(np.stack(xs, axis=1)).to(DEVICE)
    err_ref = max_err(got, sell_core.spmm_sell_ref(
        arrs["cols"], arrs["vals"], arrs["rows"], x_stack,
        n_rows=cage.n_rows))
    err_host = max(max_err(got[:, i].cpu(), torch.from_numpy(
        cage.matvec(xs[i]))) for i in range(4))
    phase("fft", f"cage10: {FFT_SPMV_REQUESTS} SpMV results vs plain on card "
          f"{err_ref:.3e}, 4 vs host CSR matvec {err_host:.3e} (tol 1e-10)")
    if not (err_ref <= 1e-10 and err_host <= 1e-10):
        raise AssertionError("SpMV results of the mixed drain disagree")
    return dict(reg=reg, launches=launched, sigs=sigs)


def ellpack_ops_path(torch, np, F, spmv_k, ops, ExecSpec) -> dict:
    """Phase 7: ``ops.spmv`` / ``ops.spmm`` on ELLPACK operands at the
    default vl = C = 256, so both reach B6 and not a repack."""
    t0 = time.perf_counter()
    cage = F.csr_to_ellpack(F.cage10_like(seed=0), c=ELL_C)
    csr = F.random_csr(**ELL_BIG)
    big = F.csr_to_ellpack(csr, c=ELL_C)
    phase("ellpack", f"operands packed in {time.perf_counter() - t0:.1f} s: "
          f"cage10 width {cage.width} pad {cage.pad_factor:.4f}; uniform2m "
          f"{big.n_rows} rows nnz {big.nnz} width {big.width} pad "
          f"{big.pad_factor:.4f}, {big.cols.nbytes + big.vals.nbytes} B of "
          "slabs")
    spec = ExecSpec(device=DEVICE)
    if spec.vl != ELL_C:
        raise AssertionError(f"default vl {spec.vl} != C {ELL_C}")
    rng = np.random.default_rng(8)
    x1 = rng.standard_normal(cage.n_cols)
    xk = rng.standard_normal((big.n_cols, ELL_K))
    tiles = len(ell_tiles(ELL_K, 8))
    torch.cuda.synchronize()
    spmv_k.KERNEL_LAUNCHES = 0
    spmv_k.SPMM_LAUNCHES = 0
    t0 = time.perf_counter()
    y1 = ops.spmv(cage, x1, spec=spec)
    yk = ops.spmm(big, xk, spec=spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k_launches = spmv_k.KERNEL_LAUNCHES, spmv_k.SPMM_LAUNCHES
    phase("ellpack", f"spmv.KERNEL_LAUNCHES grew by {launches} (1 + {tiles} "
          f"k tile(s) of the k-column form expected, where the "
          f"column-by-column walk made 1 + {ELL_K}); ops wall {wall:.2f} s "
          "incl. bounds scan, upload and live widths")
    if launches != 1 + tiles or k_launches != tiles:
        raise AssertionError(f"B6 launches {launches} ({k_launches} of the k "
                             f"form) != 1 + {tiles}")
    if tuple(y1.shape) != (cage.n_rows,) or \
            tuple(yk.shape) != (big.n_rows, ELL_K) or \
            not bool(torch.isfinite(yk).all()):
        raise AssertionError("ELLPACK ops: bad result shapes or values")
    errs = {}
    for name, ell, y, x in (("cage10", cage, y1[:, None], x1[:, None]),
                            ("uniform2m", big, yk, xk)):
        cols, vals, _ = ops._prepared(ell, torch.device(DEVICE))[1]
        xd = torch.from_numpy(x).to(DEVICE)
        plain = torch.stack([spmv_k.spmv_ell_ref(cols, vals, xd[:, i]
                                                 .contiguous())[:ell.n_rows]
                             for i in range(x.shape[1])], dim=1)
        err_ref = max_err(y, plain)
        err_host = max(max_err(y[:, i].cpu(), torch.from_numpy(
            ell.matvec(x[:, i]))) for i in range(min(4, x.shape[1])))
        phase("ellpack", f"{name}: {x.shape[1]} column(s) vs plain on card "
              f"max abs err {err_ref:.3e}, {min(4, x.shape[1])} vs host "
              f"EllpackMatrix.matvec {err_host:.3e} (tol 1e-10)")
        if not (err_ref <= 1e-10 and err_host <= 1e-10):
            raise AssertionError(f"{name}: ELLPACK results disagree")
        errs[name] = err_ref
    return dict(big=big, csr=csr, launches=launches - k_launches,
                k_launches=k_launches, errs=errs)


def time_fft(torch, np, fft_k, fm: dict, flush) -> list[dict]:
    """Phase 8 (FFT): B7 in both forms at the service shapes, fp64, with
    the two-pass form's own bytes (the batch read and written by each
    pass) beside the function's bound."""
    out = []
    for name, kernel in (("fft2048", "fft_stockham_block"),
                         ("fft131072", "fft_stockham_two_pass")):
        n, rows = FFT_PLANS[name]
        batch = rows * FFT_REQUESTS_PER_PLAN
        arrs = fm["reg"].get(name).device_arrays
        re = torch.from_numpy(np.concatenate(fm["sigs"][name])).to(DEVICE)
        im = torch.zeros_like(re)
        z = torch.complex(re, im)

        def run():
            return fft_k.fft_stockham(re, im, arrs["wre"], arrs["wim"],
                                      b_block=8)

        def plain():
            return fft_k.fft_stockham_ref(re, im, arrs["wre"], arrs["wim"])

        def library():
            return torch.fft.fft(z)

        got, want, lib = run(), plain(), library()
        torch.cuda.synchronize()
        err = check_fft(torch, np, f"{name} B7 vs plain", got, want, n,
                        np.float64)
        check_fft(torch, np, f"{name} B7 vs torch.fft.fft", got,
                  (lib.real, lib.imag), n, np.float64)
        ms = time_ms(torch, run, flush)
        plain_ms = time_ms(torch, plain, flush)
        lib_ms = time_ms(torch, library, flush)
        stages = int(np.log2(n))
        # both planes read and written once, and row 0 of the two twiddle
        # tables (n / 2 entries each): the only row the function needs
        bytes_ms = (32 * batch * n + 8 * n) / HBM_BYTES_PER_S * 1e3
        ops_ms = 5 * n * stages * batch / FP64_FLOPS * 1e3
        # the form's own bytes: one read and one write of both planes per
        # launch (in-block: one launch; two-pass: two, through scratch)
        passes = 1 if kernel == "fft_stockham_block" else 2
        form_ms = passes * 32 * batch * n / HBM_BYTES_PER_S * 1e3
        rec = {"name": kernel, "route": "cuda",
               "source": "src/repro_torch/csrc/fft_stockham.cu",
               "replaces": "src/repro/kernels/fft.py:24",
               "launches": fm["launches"][kernel], "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": lib_ms,
               "shape": f"{name}: ({batch}, {n}) fp64, b_block 8"}
        out.append(rec)
        phase("timing", f"{name} ({batch}, {n}) fp64: {kernel} {ms:.4f} ms |"
              f" bound {bytes_ms:.4f} ms (bytes; ops {ops_ms:.4f}) | the "
              f"form's bytes ({passes} pass(es)) {form_ms:.4f} ms | plain "
              f"{plain_ms:.4f} ms | torch.fft.fft {lib_ms:.4f} ms | max abs "
              f"err vs plain {err:.3e}")
    return out


def time_spmv_ell(torch, np, spmv_k, ops, em: dict, flush) -> list[dict]:
    """Phase 11 (ELLPACK): B6 on the 2M-row operand, fp64, one column and
    then ELL_K columns as one ``ops.spmm``-shaped call (the cached live
    widths handed in), beside the column-by-column walk (ELL_K one-column
    launches) and ``torch.sparse.mm`` at the same k."""
    big, csr = em["big"], em["csr"]
    cols, vals, live = ops._prepared(big, torch.device(DEVICE))[1]
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(big.n_cols)).to(DEVICE)
    X = torch.from_numpy(rng.standard_normal((big.n_cols, ELL_K))).to(DEVICE)
    a_lib = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr),
        torch.from_numpy(csr.indices.astype(np.int64)),
        torch.from_numpy(csr.data), size=(csr.n_rows, csr.n_cols)).to(DEVICE)
    xc = x[:, None]

    def run():
        return spmv_k.spmv_ell(cols, vals, x, live_width=live)

    def plain():
        return spmv_k.spmv_ell_ref(cols, vals, x)

    def library():
        return torch.sparse.mm(a_lib, xc)

    got, want, lib = run(), plain(), library()
    torch.cuda.synchronize()
    err = max_err(got, want)
    err_lib = max_err(got[:big.n_rows], lib[:, 0])
    if not (err <= 1e-10 and err_lib <= 1e-10):
        raise AssertionError(f"B6 vs plain {err}, vs sparse.mm {err_lib}")
    ms = time_ms(torch, run, flush)
    plain_ms = time_ms(torch, plain, flush)
    lib_ms = time_ms(torch, library, flush)
    lanes = big.n_slices * big.c
    x_rows = touched_columns(np, big.cols, big.n_cols)
    bytes_ms = (12 * big.nnz + 8 * x_rows + 8 * big.n_rows) \
        / HBM_BYTES_PER_S * 1e3
    padded_ms = (12 * big.padded_nnz + 8 * big.n_cols + 8 * lanes) \
        / HBM_BYTES_PER_S * 1e3
    live_h = live.cpu().numpy()
    walked = int((live_h.astype(np.int64) * 32).sum())
    walk_ms = (12 * walked + 8 * x_rows + 8 * lanes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * big.nnz / FP64_FLOPS * 1e3
    phase("timing", f"uniform2m ELLPACK k=1: spmv_ell {ms:.4f} ms (goal <= "
          f"0.36: {'met' if ms <= 0.36 else 'missed'}) | bound "
          f"{bytes_ms:.4f} ms (bytes; ops {ops_ms:.4f}) | slots walked to "
          f"the live widths {walked} of {big.padded_nnz} stored "
          f"({walked / big.padded_nnz:.3f}), their bytes {walk_ms:.4f} ms | "
          f"padded-ELLPACK (width {big.width}) bytes bound {padded_ms:.4f} "
          f"ms | plain {plain_ms:.4f} ms | torch.sparse.mm {lib_ms:.4f} ms | "
          f"max abs err vs plain {err:.3e}, vs sparse.mm {err_lib:.3e}")
    one = {"name": "spmv_ell", "route": "cuda",
           "source": "src/repro_torch/csrc/spmv_ell.cu",
           "replaces": "src/repro/kernels/spmv.py:28",
           "launches": em["launches"], "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": lib_ms,
           "shape": f"uniform2m ELLPACK {big.n_rows} rows nnz {big.nnz} "
                    f"width {big.width} C={big.c} fp64, k=1"}

    k = ELL_K
    cols_x = [X[:, i].contiguous() for i in range(k)]

    def run_k():
        return spmv_k.spmm_ell(cols, vals, X, live_width=live)

    def by_column():
        return [spmv_k.spmv_ell(cols, vals, xi, live_width=live)
                for xi in cols_x]

    def plain_k():
        return spmv_k.spmm_ell_ref(cols, vals, X)

    def library_k():
        return torch.sparse.mm(a_lib, X)

    gk, wk, lk = run_k(), plain_k(), library_k()
    cbc = torch.stack(by_column(), dim=1)
    torch.cuda.synchronize()
    if not torch.equal(gk, cbc):
        raise AssertionError("B6 k form != column by column at uniform2m")
    err_k = max_err(gk, wk)
    err_lk = max_err(gk[:big.n_rows], lk)
    if not (err_k <= 1e-10 and err_lk <= 1e-10):
        raise AssertionError(f"B6 k form vs plain {err_k}, vs sparse.mm "
                             f"{err_lk}")
    del wk, lk, cbc
    ms_k = time_ms(torch, run_k, flush)
    cbc_ms = time_ms(torch, by_column, flush)
    plain_k_ms = time_ms(torch, plain_k, flush, runs=3, warmup=1)
    lib_k_ms = time_ms(torch, library_k, flush)
    least = 12 * big.nnz + 8 * k * (x_rows + big.n_rows)
    gather = 8 * k * big.nnz
    least_ms = least / HBM_BYTES_PER_S * 1e3
    ops_k_ms = 2 * k * big.nnz / FP64_FLOPS * 1e3
    phase("timing", f"uniform2m ELLPACK k={k}: spmm_ell {ms_k:.4f} ms in "
          f"{len(ell_tiles(k, 8))} launch(es) (goal <= 5: "
          f"{'met' if ms_k <= 5 else 'missed'}) | column by column ({k} "
          f"launches, bit-equal) {cbc_ms:.4f} ms | torch.sparse.mm "
          f"{lib_k_ms:.4f} ms | plain {plain_k_ms:.4f} ms | least bytes "
          f"12 nnz + 8 k (n_x + n_rows) = {least / 1e9:.3f} GB, "
          f"{least_ms:.4f} ms | X gather bytes 8 k nnz = {gather / 1e9:.3f} "
          f"GB, {gather / HBM_BYTES_PER_S * 1e3:.4f} ms | max abs err vs "
          f"plain {err_k:.3e}, vs sparse.mm {err_lk:.3e}")
    many = {"name": "spmm_ell", "route": "cuda",
            "source": "src/repro_torch/csrc/spmv_ell.cu",
            "replaces": "src/repro/kernels/spmv.py:28",
            "launches": em["k_launches"], "max_abs_err": err_k, "ms": ms_k,
            "plain_ms": plain_k_ms, "bound_ms": max(least_ms, ops_k_ms),
            "bound_by": "bytes" if least_ms >= ops_k_ms else "operations",
            "library_ms": lib_k_ms, "column_by_column_ms": cbc_ms,
            "shape": f"uniform2m ELLPACK fp64, k={k} (one ops.spmm)"}
    return [one, many]


# ---------------------------------------------------------------------------
# Streaming SpMM (B2) and MoE dispatch (B1)
# ---------------------------------------------------------------------------


def shuffled_rows(np, F, csr, seed: int):
    """The same matrix with each row's entries in a random order."""
    rng = np.random.default_rng(seed)
    indices, data = csr.indices.copy(), csr.data.copy()
    for lo, hi in zip(csr.indptr[:-1], csr.indptr[1:]):
        p = lo + rng.permutation(hi - lo)
        indices[lo:hi], data[lo:hi] = indices[p], data[p]
    return F.CSRMatrix(indptr=csr.indptr, indices=indices, data=data,
                       n_cols=csr.n_cols)


def compare_stream(torch, np, sell_core, F) -> float:
    """Phase 3 (streaming): B2 against spmm_sell_stream_ref on the card and
    bit-equal to B1, at the picked tiles and at a col_tile that splits X
    into many tiles with a non-pow2 row_tile; then rows out of column
    order.  Returns the fp64 max error against the plain version."""
    operands = {
        "cage10": lambda dt: F.cage10_like(seed=0, dtype=dt),
        "rand4093": lambda dt: F.random_csr(4093, 4093, 8.0, seed=3,
                                            skew=1.2, dtype=dt),
    }
    rng = np.random.default_rng(4)
    worst64 = 0.0
    n_cases = 0
    multi_chunk = 0
    tiles = ((None, None), (64, 3))
    for dt in (np.float64, np.float32):
        for name, make in operands.items():
            csr = make(dt)
            split_layouts = []
            for c in (8, 32, 128, 256):
                slabs = F.csr_to_sell_slabs(csr, c=c)
                cols, vals, rows = slabs.to_device(DEVICE)
                if sell_core.splits(cols):
                    split_layouts.append(c)
                # the (64, 3) tiles: blocks whose column lists take more
                # than one chunk of 64 staged X rows
                smap = F.stream_column_map(slabs.bucket_cols,
                                           sell_core.stream_bucket_rows(
                                               3, [a.shape for a in cols]))
                chunks = max(-(-n // 64) for n in smap.longest)
                for k in (1, 3, 8, 32):
                    x = torch.from_numpy(rng.standard_normal(
                        (csr.n_cols, k)).astype(dt)).to(DEVICE)
                    b1 = sell_core.spmm_sell(cols, vals, rows, x,
                                             n_rows=csr.n_rows, k_block=32)
                    for ct, rt in tiles:
                        got = sell_core.spmm_sell_stream(
                            cols, vals, rows, x, n_rows=csr.n_rows,
                            k_block=32, col_tile=ct, row_tile=rt)
                        torch.cuda.synchronize()
                        want = sell_core.spmm_sell_stream_ref(
                            cols, vals, rows, x, n_rows=csr.n_rows,
                            col_tile=ct or 256)
                        err = max_err(got, want)
                        if dt == np.float64:
                            tol = 1e-10
                            worst64 = max(worst64, err)
                        else:
                            tol = 1e-4 * float(want.abs().max())
                        if not err <= tol:
                            raise AssertionError(
                                f"B2 vs plain: {name} {np.dtype(dt).name} "
                                f"C={c} k={k} tiles={ct, rt}: max abs err "
                                f"{err} > {tol}")
                        same, how = b2_matches_b1(torch, sell_core, got, b1, cols)
                        if not same:
                            raise AssertionError(
                                f"B2 != B1: {name} {np.dtype(dt).name} C={c} "
                                f"k={k} tiles={ct, rt} ({how})")
                        n_cases += 1
                        multi_chunk += ct == 64 and chunks > 1
            phase("compare", f"B2 {name} {np.dtype(dt).name}: C in (8, 32, "
                  f"128, 256) x k in (1, 3, 8, 32) x (col_tile, row_tile) in "
                  f"{tiles} within tolerance of plain and bit-equal to B1 "
                  f"(split-bucket layouts within tolerance of B1: "
                  f"{split_layouts})")
    # rows out of column order, then the same rows with PAD first: B2 reads
    # the slabs B1 reads and stays bit-equal to it
    slabs = F.csr_to_sell_slabs(
        shuffled_rows(np, F, F.cage10_like(seed=0), seed=5), c=32)
    pad_first = dataclasses.replace(
        slabs,
        bucket_cols=tuple(np.roll(c, 1, axis=1) for c in slabs.bucket_cols),
        bucket_vals=tuple(np.roll(v, 1, axis=1) for v in slabs.bucket_vals))
    x = torch.from_numpy(rng.standard_normal((slabs.n_cols, 8))).to(DEVICE)
    err_unsorted = 0.0
    for operand in (slabs, pad_first):
        cols, vals, rows = operand.to_device(DEVICE)
        b1 = sell_core.spmm_sell(cols, vals, rows, x, n_rows=slabs.n_rows,
                                 k_block=8)
        got = sell_core.spmm_sell_stream(cols, vals, rows, x,
                                         n_rows=slabs.n_rows, k_block=8)
        torch.cuda.synchronize()
        same, how = b2_matches_b1(torch, sell_core, got, b1, cols)
        if not same:
            raise AssertionError(f"B2 != B1 on rows out of column order "
                                 f"({how})")
        want = sell_core.spmm_sell_stream_ref(cols, vals, rows, x,
                                              n_rows=slabs.n_rows,
                                              col_tile=256)
        err_unsorted = max(err_unsorted, max_err(got, want))
        if not err_unsorted <= 1e-10:
            raise AssertionError(
                f"B2 vs plain on rows out of column order: {err_unsorted}")
        n_cases += 1
    if multi_chunk == 0:
        raise AssertionError("no B2 compare case walked more than one chunk "
                             "a block")
    phase("compare", f"{n_cases} B2 cases ok ({multi_chunk} with blocks of "
          f"more than one 64-row chunk); fp64 max abs err vs plain "
          f"{worst64:.3e} (tol 1e-10), fp32 tol 1e-4 * max|y|; every case "
          f"bit-equal to B1 where B1 splits no bucket (within its tolerance "
          f"on the split layouts listed above), cage10 with shuffled rows "
          f"and with PAD first too (vs plain {err_unsorted:.3e}, tol 1e-10)")
    return worst64


#: seconds ops took to build, scan and upload each B2 column map, by
#: (id(slabs), block rows): one build a map, read by every phase after
MAP_BUILD_S: dict = {}


def ops_stream_map(torch, ops, slabs, block_rows):
    """B2's column map of ``slabs`` at ``block_rows`` as ``ops`` caches it
    (built, scanned and uploaded at the first call, then found there):
    (host map, map on the card, seconds of that one build)."""
    dev = torch.device(DEVICE)
    key = (id(slabs), tuple(block_rows))
    t0 = time.perf_counter()
    ops._prepared(slabs, dev)
    _, dmap = ops._stream_map(slabs, tuple(block_rows), dev)
    MAP_BUILD_S.setdefault(key, time.perf_counter() - t0)
    host = ops._PREPARED[id(slabs)][("stream", tuple(block_rows))][0]
    return host, dmap, MAP_BUILD_S[key]


def stream_path(torch, np, F, sell_core, ops, ExecSpec) -> dict:
    """Phase 8: the streaming schedule through ``ops`` (kernel B2)."""
    from repro_torch.core.autotune import pick_stream_tiles

    t0 = time.perf_counter()
    cage = F.cage10_like(seed=0)
    giant = F.random_csr(**GIANT)
    rng = np.random.default_rng(10)
    xc = rng.standard_normal((cage.n_cols, REQUESTS_PER_OPERAND))
    xg = rng.standard_normal((giant.n_cols, GIANT_K))
    xv = rng.standard_normal(giant.n_cols)
    phase("stream", f"operands generated in {time.perf_counter() - t0:.1f} s:"
          f" giant {giant.n_rows}x{giant.n_cols} nnz {giant.nnz}, X "
          f"{xg.nbytes} B at k={GIANT_K}")
    spec = ExecSpec(device=DEVICE, mode="stream")
    # pack once, so the B1 check below reuses the same slabs and uploads
    t0 = time.perf_counter()
    slabs = {"cage10": F.csr_to_sell_slabs(cage, c=spec.vl),
             "giant": F.csr_to_sell_slabs(giant, c=spec.vl)}
    packed = time.perf_counter() - t0
    # what ops builds once per operand for B2: the block column lists,
    # built here through ops' own cache (at the block rows ops picks for
    # these calls) to time the build, then found there by the calls below
    built = []
    for name, k in (("cage10", REQUESTS_PER_OPERAND), ("giant", GIANT_K)):
        sl = slabs[name]
        rt = pick_stream_tiles(sl.c, sell_core.k_tile_for(k, min(
            8, sell_core.pow2_ceil(k))))[1]
        rows = sell_core.stream_bucket_rows(rt, [a.shape for a in
                                                 sl.bucket_cols])
        smap, _, secs = ops_stream_map(torch, ops, sl, rows)
        built.append(f"{name} {secs:.3f} s ({smap.x_rows} (block, column) "
                     f"pairs, block rows {rows})")
    phase("stream", f"packed in {packed:.3f} s; B2 column maps built, scanned "
          "and uploaded by ops in "
          + "; ".join(built))
    torch.cuda.synchronize()
    sell_core.STREAM_LAUNCHES = 0
    t0 = time.perf_counter()
    ys = {"cage10": ops.spmm(slabs["cage10"], xc, spec=spec),
          "giant": ops.spmm(slabs["giant"], xg, spec=spec),
          "giant_spmv": ops.spmv(slabs["giant"], xv, spec=spec)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sell_core.STREAM_LAUNCHES
    expected = 2 * slabs["giant"].n_buckets + slabs["cage10"].n_buckets
    phase("stream", f"STREAM_LAUNCHES={launches} (one per bucket per call: "
          f"{expected}); ops wall {wall:.3f} s incl. bounds scan and "
          "upload")
    if launches != expected or launches <= 0:
        raise AssertionError(f"B2 launches {launches} != {expected}")
    resident = dataclasses.replace(spec, mode="resident")
    for name, csr, y, x in (
            ("cage10", cage, ys["cage10"], xc),
            ("giant", giant, ys["giant"], xg),
            ("giant_spmv", giant, ys["giant_spmv"][:, None], xv[:, None])):
        if tuple(y.shape) != (csr.n_rows, x.shape[1]) or \
                not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name}: bad result shape/values")
        b1 = ops.spmm(slabs[name.removesuffix("_spmv")], x, spec=resident)
        same, how = b2_matches_b1(
            torch, sell_core, y, b1, slabs[name.removesuffix("_spmv")].bucket_cols)
        if not same:
            raise AssertionError(f"{name}: B2 through ops != B1 "
                                 f"(max abs err {max_err(y, b1)}; {how})")
        err_host = max(max_err(y[:, i].cpu(), torch.from_numpy(
            csr.matvec(x[:, i]))) for i in range(min(4, x.shape[1])))
        phase("stream", f"{name} k={x.shape[1]}: {how} to B1 on the "
              f"card; {min(4, x.shape[1])} column(s) vs host CSR matvec "
              f"{err_host:.3e} (tol 1e-10)")
        if not err_host <= 1e-10:
            raise AssertionError(f"{name}: B2 disagrees with CSR matvec")
    return dict(launches=launches, cage=cage, giant=giant, slabs=slabs)


def moe_routing(np, rng, n_tok: int, n_experts: int, top_k: int, cap: int):
    """One decode step's combine CSR (tokens x expert capacity slots),
    drawn as ``src/repro/models/moe.py`` builds it: softmax router
    probabilities, top-k experts, renormalized weights, each assignment's
    rank within its expert in (token, k) order, assignments past the
    capacity dropped; a row lists its kept entries in k order."""
    logits = rng.standard_normal((n_tok, n_experts))
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    top_i = np.argsort(-probs, axis=1, kind="stable")[:, :top_k]
    top_w = np.take_along_axis(probs, top_i, axis=1)
    top_w /= np.maximum(top_w.sum(axis=1, keepdims=True), 1e-9)
    flat = top_i.reshape(-1)
    onehot = np.eye(n_experts, dtype=np.int64)[flat]
    pos = (np.cumsum(onehot, axis=0) - onehot)[np.arange(flat.size), flat]
    keep = pos < cap
    tok = np.repeat(np.arange(n_tok), top_k)[keep]
    indptr = np.zeros(n_tok + 1, np.int64)
    np.cumsum(np.bincount(tok, minlength=n_tok), out=indptr[1:])
    return indptr, (flat * cap + pos)[keep].astype(np.int32), \
        top_w.reshape(-1)[keep]


def block_diagonal(np, F, payloads):
    """The service's coalesced operand: request i's routing as the i-th
    block of one CSR, its X stack the matching rows of one RHS."""
    indptrs, indices, data = [np.zeros(1, np.int64)], [], []
    row = col = nnz = 0
    for p in payloads:
        indptrs.append(p["indptr"][1:] + nnz)
        indices.append(p["indices"] + col)
        data.append(p["data"])
        row += len(p["indptr"]) - 1
        col += p["x"].shape[0]
        nnz += int(p["indptr"][-1])
    return F.CSRMatrix(indptr=np.concatenate(indptrs),
                       indices=np.concatenate(indices).astype(np.int32),
                       data=np.concatenate(data), n_cols=col)


def moe_path(torch, np, F, sell_core, ops, ExecSpec, KernelRegistry,
             KernelService) -> dict:
    """Phase 9: MoE dispatch traffic through the registry and the service
    (kernel B1 on block-diagonal launch sets)."""
    reg = KernelRegistry(device=DEVICE)
    rng = np.random.default_rng(11)
    envelopes = {}
    t0 = time.perf_counter()
    for name, m in MOE_MODELS.items():
        cap = int(MOE_TOKENS * m["top_k"] / m["n_experts"]
                  * MOE_CAPACITY_FACTOR) + 1
        n_slots = m["n_experts"] * cap
        op = reg.register_moe(name, n_tokens=MOE_TOKENS, n_slots=n_slots,
                              d_model=m["d_model"], top_k=m["top_k"],
                              c=MOE_C)
        payloads = []
        for _ in range(MOE_REQUESTS):
            indptr, indices, data = moe_routing(
                np, rng, MOE_TOKENS, m["n_experts"], m["top_k"], cap)
            payloads.append(dict(indptr=indptr, indices=indices, data=data,
                                 x=rng.standard_normal((n_slots,
                                                        m["d_model"]))))
        envelopes[name] = dict(cap=cap, n_slots=n_slots, payloads=payloads,
                               d=m["d_model"], top_k=m["top_k"])
        plan = op.plans["moe_dispatch"]
        phase("moe", f"registered {name}: d_model {m['d_model']}, "
              f"{m['n_experts']} experts top-{m['top_k']}, capacity {cap} "
              f"a expert, {n_slots} slots, plan {plan.n_launches} launch(es)")
    phase("moe", f"payloads generated in {time.perf_counter() - t0:.1f} s")
    svc = KernelService(reg, n_slots=N_SLOTS)
    # one drain an envelope, its B1 launches counted around it
    rids, wall = {}, 0.0
    for name, e in envelopes.items():
        torch.cuda.synchronize()
        sell_core.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        rids[name] = [svc.submit("moe_dispatch", name, p)
                      for p in e["payloads"]]
        svc.drain()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        e["launches"] = sell_core.KERNEL_LAUNCHES
    b1 = sum(e["launches"] for e in envelopes.values())
    stats = dict(svc.stats)
    n_req = sum(len(v) for v in rids.values())
    walls = svc.metrics.get("launch_wall_us_moe_dispatch")
    phase("moe", f"stats {json.dumps(stats)}")
    phase("moe", f"moe_dispatch_launches={stats['moe_dispatch_launches']}, "
          f"sell_core.KERNEL_LAUNCHES=" + ", ".join(
              f"{n} {e['launches']}" for n, e in envelopes.items()) +
          f"; {n_req} requests in {wall:.4f} s "
          f"= {n_req / wall:.1f} requests/s; dispatch calls (pack + upload + "
          f"kernels + sync) {walls.total / 1e3:.3f} ms over {walls.count} "
          "groups")
    if stats["served"] != n_req or stats["failed"]:
        raise AssertionError(f"not every request was served: {stats}")
    if stats["moe_dispatch_launches"] != len(envelopes):
        raise AssertionError("each envelope's 32 requests did not coalesce "
                             f"into one launch set: {stats}")
    for name, e in envelopes.items():
        csr = block_diagonal(np, F, e["payloads"])
        slabs = F.csr_to_sell_slabs(csr, c=MOE_C)
        if e["launches"] != slabs.n_buckets or e["launches"] <= 0:
            raise AssertionError(
                f"{name}: B1 launches {e['launches']} != buckets of its "
                f"launch set {slabs.n_buckets}")
        cols, vals, rows = slabs.to_device(DEVICE)
        x = torch.from_numpy(np.concatenate(
            [p["x"] for p in e["payloads"]])).to(DEVICE)
        got = torch.cat([svc.poll(r) for r in rids[name]])
        if tuple(got.shape) != (csr.n_rows, e["d"]) or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: bad result shape/values")
        err_plain = max_err(got, sell_core.spmm_sell_ref(
            cols, vals, rows, x, n_rows=csr.n_rows))
        dense = ExecSpec(dispatch="dense", device=DEVICE)
        err_dense = max(max_err(svc.poll(r), ops.moe_dispatch(
            F.CSRMatrix(indptr=p["indptr"], indices=p["indices"],
                        data=p["data"], n_cols=e["n_slots"]),
            p["x"], spec=dense, top_k=e["top_k"]))
            for r, p in zip(rids[name], e["payloads"]))
        err_host = 0.0
        for r, p in list(zip(rids[name], e["payloads"]))[:4]:
            r_dense = np.zeros((MOE_TOKENS, e["n_slots"]))
            rows_of = np.repeat(np.arange(MOE_TOKENS), np.diff(p["indptr"]))
            r_dense[rows_of, p["indices"]] = p["data"]
            err_host = max(err_host, max_err(
                svc.poll(r).cpu(), torch.from_numpy(r_dense @ p["x"])))
        phase("moe", f"{name}: {len(rids[name])} results ({csr.n_rows} "
              f"tokens x {csr.n_cols} slots, nnz {csr.nnz}, k={e['d']}) vs "
              f"plain on card {err_plain:.3e}, vs dense dispatch "
              f"{err_dense:.3e}, 4 vs numpy R @ X {err_host:.3e} (tol 1e-10)")
        if not max(err_plain, err_dense, err_host) <= 1e-10:
            raise AssertionError(f"{name}: dispatch results disagree")
        e.update(csr=csr, slabs=(cols, vals, rows), x=x)
    return dict(envelopes=envelopes, launches=b1,
                requests_per_s=n_req / wall)


def stream_traffic(smap, k: int, k_tile: int, itemsize: int, col_tile: int):
    """What B2's schedule moves besides the function's bytes, counted on the
    host from its block column lists: ((block, column) pairs, chunks, X
    bytes, map bytes).  Each block stages each column its rows name once
    per k tile (where its rows ascend); the map adds 4 B a listed column,
    8 B a block and 4 B a lane (lane_end), read once per k tile."""
    from repro_torch.analysis.preflight import stream_chunk_rows

    grid_y = -(-k // k_tile)
    chunks = sum(int(-(-(p[1:] - p[:-1]) // stream_chunk_rows(col_tile, n))
                     .sum()) for p, n in zip(smap.block_ptr, smap.longest))
    map_bytes = sum(4 * len(lst) + 8 * len(p) + 4 * e.size for lst, p, e in
                    zip(smap.block_cols, smap.block_ptr, smap.lane_end))
    return (smap.x_rows, chunks * grid_y,
            smap.x_rows * k_tile * itemsize * grid_y, map_bytes * grid_y)


def sparse_csr(torch, np, csr):
    """``csr`` as a torch sparse CSR tensor on the card (the library
    yardstick's operand)."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr),
        torch.from_numpy(csr.indices.astype(np.int64)),
        torch.from_numpy(csr.data), size=(csr.n_rows, csr.n_cols)).to(DEVICE)


def time_stream(torch, np, sell_core, ops, sm: dict, big_op, big,
                flush) -> dict:
    """Phase 10 (streaming): B2 beside B1 at seven shapes (cage10 k = 1,
    32; the giant operand k = 1, 8, 32; BIG k = 1, 32), with its bound (B1's
    bytes), the bytes its schedule moves (the staged X rows and its column
    map) and the map's build time; then the rule ``mode="auto"`` follows."""
    from repro_torch.analysis.preflight import (stream_chunk_rows,
                                                stream_col_tile)
    from repro_torch.core.autotune import pick_stream_tiles

    dev = torch.device(DEVICE)
    layouts = {
        "cage10": (sm["cage"], sm["slabs"]["cage10"],
                   ops._prepared(sm["slabs"]["cage10"], dev)[1]),
        "giant": (sm["giant"], sm["slabs"]["giant"],
                  ops._prepared(sm["slabs"]["giant"], dev)[1]),
        "big": (big, big_op.slabs, ops._prepared(big_op.slabs, dev)[1]),
    }
    # the column maps come from ops' cache with the uploads above: cage10's
    # and giant's as the stream phase built them, big's built there once
    shapes = [("cage10", 1), ("cage10", REQUESTS_PER_OPERAND), ("giant", 1),
              ("giant", GIANT_K), ("giant", REQUESTS_PER_OPERAND), ("big", 1),
              ("big", REQUESTS_PER_OPERAND)]
    rng = np.random.default_rng(12)
    records = {}
    for name, k in shapes:
        csr, slabs, (cols, vals, rows) = layouts[name]
        x = torch.from_numpy(rng.standard_normal((csr.n_cols, k))).to(DEVICE)
        a_lib = sparse_csr(torch, np, csr)
        kt = sell_core.k_tile_for(k, 32)
        ct, rt = pick_stream_tiles(slabs.c, kt, 8)
        ct = stream_col_tile(ct, csr.n_cols)
        block_rows = sell_core.stream_bucket_rows(
            rt, [a.shape for a in slabs.bucket_cols])
        smap, dmap, built_s = ops_stream_map(torch, ops, slabs, block_rows)

        def b2():
            return sell_core.spmm_sell_stream(cols, vals, rows, x,
                                              n_rows=csr.n_rows, k_block=32,
                                              column_map=dmap)

        def b1():
            return sell_core.spmm_sell(cols, vals, rows, x,
                                       n_rows=csr.n_rows, k_block=32)

        def plain():
            return sell_core.spmm_sell_stream_ref(cols, vals, rows, x,
                                                  n_rows=csr.n_rows,
                                                  col_tile=ct)

        def library():
            return torch.sparse.mm(a_lib, x)

        y2, y1, yp, yl = b2(), b1(), plain(), library()
        torch.cuda.synchronize()
        err, err_lib = max_err(y2, yp), max_err(y2, yl)
        same, how = b2_matches_b1(torch, sell_core, y2, y1, cols)
        if not (same and err <= 1e-10 and err_lib <= 1e-10):
            raise AssertionError(f"{name} k={k}: B2 vs B1 {how}, vs plain "
                                 f"{err}, vs sparse.mm {err_lib}")
        # B1 and B2 in turns (B1, B2, B2, B1) inside this one run
        b1_ms = [time_ms(torch, b1, flush)]
        ms = [time_ms(torch, b2, flush), time_ms(torch, b2, flush)]
        b1_ms.append(time_ms(torch, b1, flush))
        plain_ms = time_ms(torch, plain, flush)
        lib_ms = time_ms(torch, library, flush)
        pairs, chunks, x_bytes, map_bytes = stream_traffic(smap, k, kt, 8, ct)
        x_rows = touched_columns(np, csr.indices, csr.n_cols)
        least = csr.nnz * 12 + 4 * csr.n_rows + 8 * k * (x_rows + csr.n_rows)
        bytes_ms = least / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * csr.nnz * k / FP64_FLOPS * 1e3
        sched_ms = (least - 8 * k * x_rows + x_bytes + map_bytes) \
            / HBM_BYTES_PER_S * 1e3
        if name == "big":
            # per bucket: which widths hold the schedule back
            xk = x.contiguous()
            y = torch.empty((csr.n_rows + 1, k), dtype=x.dtype, device=DEVICE)
            stream = torch.cuda.current_stream().cuda_stream
            per = [time_ms(torch, lambda b=b: sell_core._launch_stream_bucket(
                dmap.lcols[b], vals[b], rows[b], dmap.lane_end[b],
                dmap.block_ptr[b], dmap.block_cols[b], xk, y, kt,
                stream_chunk_rows(ct, smap.longest[b]), block_rows[b],
                stream), flush,
                runs=5, warmup=1) for b in range(len(cols))]
            phase("timing", f"big k={k} B2 per bucket (W: slices, block "
                  "rows, longest list, ms): " + ", ".join(
                      f"{a.shape[1]}: {a.shape[0]}, {r}, {n}, {t:.4f}"
                      for a, r, n, t in zip(cols, block_rows, smap.longest,
                                            per)))
        rec = dict(ms=statistics.mean(ms), ms_runs=ms,
                   b1_ms=statistics.mean(b1_ms), b1_ms_runs=b1_ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   map_build_s=built_s, max_abs_err=err)
        records[name, k] = rec
        phase("timing", f"{name} k={k}: B2 {rec['ms']:.4f} ms (runs "
              f"{ms[0]:.4f}, {ms[1]:.4f}) | B1 {rec['b1_ms']:.4f} ms (runs "
              f"{b1_ms[0]:.4f}, {b1_ms[1]:.4f}) | bound {bytes_ms:.4f} ms "
              f"(bytes; ops {ops_ms:.4f}) | schedule bytes bound "
              f"{sched_ms:.4f} ms ({x_bytes} B of X over {pairs} (block, "
              f"column) pairs in {chunks} chunks, {map_bytes} B of column "
              f"map; col_tile {ct}, block rows {sorted(set(block_rows))}, "
              f"map built, scanned and uploaded by ops in {built_s:.3f} s) | plain {plain_ms:.4f} ms | "
              f"torch.sparse.mm {lib_ms:.4f} ms | max abs err vs plain "
              f"{err:.3e}, B2 vs B1 {how}")
    faster = [f"{n} k={k} ({r['b1_ms'] / r['ms']:.2f}x)"
              for (n, k), r in records.items() if r["ms"] < 0.9 * r["b1_ms"]]
    phase("timing", "auto rule: B2 beats B1 by more than 10% on " + (
        ", ".join(faster) if faster else "no measured shape") +
        f"; ops resolves mode='auto' to the resident B1")
    return records


def time_moe(torch, np, sell_core, mm: dict, flush) -> list[dict]:
    """Phase 10 (MoE): each envelope's coalesced launch set on B1 beside
    the dense ``torch.matmul`` of R (the reference's counterfactual) and
    ``torch.sparse.mm``."""
    out = []
    for name, e in mm["envelopes"].items():
        csr, (cols, vals, rows), x = e["csr"], e["slabs"], e["x"]
        r_dense = torch.zeros((csr.n_rows, csr.n_cols), dtype=x.dtype,
                              device=DEVICE)
        rows_of = np.repeat(np.arange(csr.n_rows), np.diff(csr.indptr))
        r_dense[torch.from_numpy(rows_of).to(DEVICE),
                torch.from_numpy(csr.indices.astype(np.int64)).to(DEVICE)] = \
            torch.from_numpy(csr.data).to(DEVICE)
        a_lib = sparse_csr(torch, np, csr)
        kb = 32

        def run():
            return sell_core.spmm_sell(cols, vals, rows, x, n_rows=csr.n_rows,
                                       k_block=kb)

        def plain():
            return sell_core.spmm_sell_ref(cols, vals, rows, x,
                                           n_rows=csr.n_rows)

        def dense():
            return torch.matmul(r_dense, x)

        def library():
            return torch.sparse.mm(a_lib, x)

        y, yp, yd, yl = run(), plain(), dense(), library()
        torch.cuda.synchronize()
        err = max_err(y, yp)
        if not max(err, max_err(y, yd), max_err(y, yl)) <= 1e-10:
            raise AssertionError(f"{name}: B1 vs plain {err}, vs dense "
                                 f"{max_err(y, yd)}, vs sparse.mm "
                                 f"{max_err(y, yl)}")
        ms = time_ms(torch, run, flush)
        plain_ms = time_ms(torch, plain, flush)
        dense_ms = time_ms(torch, dense, flush)
        lib_ms = time_ms(torch, library, flush)
        k = e["d"]
        x_rows = touched_columns(np, csr.indices, csr.n_cols)
        bytes_ms = (12 * csr.nnz + 4 * csr.n_rows + 8 * k * (x_rows
                                                            + csr.n_rows)) \
            / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * csr.nnz * k / FP64_FLOPS * 1e3
        out.append({
            "name": f"spmm_sell[moe_dispatch {name}]", "route": "cuda",
            "source": "src/repro_torch/csrc/spmm_sell.cu",
            "replaces": "src/repro/kernels/sell_core.py:93",
            "launches": e["launches"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms, "dense_matmul_ms": dense_ms,
            "shape": f"{csr.n_rows} tokens x {csr.n_cols} slots block-"
                     f"diagonal, nnz {csr.nnz} over {x_rows} slots, k={k} "
                     "fp64"})
        phase("timing", f"moe {name} ({csr.n_rows} x {csr.n_cols}, nnz "
              f"{csr.nnz} over {x_rows} slots, k={k}): B1 {ms:.4f} ms | bound {bytes_ms:.4f} ms "
              f"(bytes; ops {ops_ms:.4f}) | plain {plain_ms:.4f} ms | dense "
              f"torch.matmul {dense_ms:.4f} ms | torch.sparse.mm "
              f"{lib_ms:.4f} ms | max abs err vs plain {err:.3e}")
    return out


def stream_record(sm: dict, records: dict) -> dict:
    """B2's entry of the kernels line: the streaming phase's giant operand
    at k = GIANT_K, with every timed shape beside it."""
    main = records["giant", GIANT_K]
    g = sm["giant"]
    return {"name": "spmm_sell_stream", "route": "cuda",
            "source": "src/repro_torch/csrc/spmm_sell_stream.cu",
            "replaces": "src/repro/kernels/sell_core.py:230",
            "launches": sm["launches"], **main,
            "shape": f"{g.n_rows}x{g.n_cols} nnz {g.nnz} fp64, k={GIANT_K}",
            "shapes": {f"{n} k={k}": r for (n, k), r in records.items()}}


# ---------------------------------------------------------------------------
# The LM path: fused SSD scan (B8) and embedding gather (B9)
# ---------------------------------------------------------------------------


def lm_config(configs):
    """The LM phase's model: mamba2-2.7b's published config."""
    return configs.get_config(LM_ARCH)


def lm_dense_config(configs):
    """The dense LM phase's model: llama-3.2-3b's published config."""
    return configs.get_config(LM_DENSE_ARCH)


def lm_moe_config(configs):
    """The MoE LM phase's model: deepseek-moe-16b's published config."""
    return configs.get_config(LM_MOE_ARCH)


def lm_family_config(configs, arch: str):
    """A families phase model: ``arch``'s published config."""
    return configs.get_config(arch)


def family_ctx(np, cfg, b: int):
    """The stub frontend's output for ``b`` sequences, float32 from
    LM_SEED: vision patch embeddings (b, n_ctx_tokens, d_ctx), enc-dec
    frames (b, n_ctx_tokens, d_model); None for the other families."""
    if cfg.encdec is not None:
        shape = (b, cfg.encdec.n_ctx_tokens, cfg.d_model)
    elif cfg.cross_attn is not None:
        shape = (b, cfg.cross_attn.n_ctx_tokens,
                 cfg.cross_attn.d_ctx or cfg.d_model)
    else:
        return None
    rng = np.random.default_rng(LM_SEED)
    return rng.standard_normal(shape).astype(np.float32)


def describe_lm(cfg) -> str:
    """The widths that shape an LM phase's model."""
    if cfg.family == "ssm":
        return (f"{cfg.n_ssm_heads} heads of {cfg.ssm.head_dim}, d_state "
                f"{cfg.ssm.d_state}, chunk {cfg.ssm.chunk}")
    if cfg.hybrid:
        s = cfg.ssm
        return (f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads of "
                f"{cfg.d_head} (sliding window {cfg.sliding_window}) in "
                f"parallel with {cfg.n_ssm_heads} SSM heads of {s.head_dim}, "
                f"d_state {s.d_state}, chunk {s.chunk}; d_ff {cfg.d_ff}")
    if cfg.moe is not None:
        m = cfg.moe
        return (f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads of "
                f"{cfg.d_head}, {m.n_experts} routed experts of d_ff "
                f"{cfg.d_ff} top-{m.top_k} + {m.n_shared} shared, capacity "
                f"factor {m.capacity_factor}, dense first layer d_ff "
                f"{cfg.dense_first_layer_ff}, "
                f"{'tied' if cfg.tie_embeddings else 'untied'} head")
    out = (f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads of {cfg.d_head}, "
           f"d_ff {cfg.d_ff}, rope theta {cfg.rope_theta:g}, "
           f"{'tied' if cfg.tie_embeddings else 'untied'} head")
    if cfg.encdec is not None:
        e = cfg.encdec
        out += (f"; a {e.encoder_layers}-layer bidirectional encoder over "
                f"{e.n_ctx_tokens} frames, decoder layers of self-attention "
                "(no MLP) then cross-attention over its memory with the MLP")
    elif cfg.cross_attn is not None:
        c = cfg.cross_attn
        out += (f"; {cfg.n_layers // c.every} groups of {c.every} self "
                f"blocks, each followed by a cross block over {c.n_ctx_tokens}"
                f" patch embeddings of {c.d_ctx} projected to d_model")
    return out


def ssd_cases(cfg, hybrid=None) -> list[tuple]:
    """B8 compare cases (b, l, h, p, g, n, chunk, dtype): the LM phase's
    prefill shapes (b 1 and LM_SLOTS) and three chunks at its widths, then
    small shapes with two groups, with l == chunk, and with three chunks
    over more (b, h) planes than the card has SMs, in fp32 and fp64; with
    ``hybrid`` (hymba's config) its prefill shapes too, (b 1 and LM_SLOTS,
    LM_PROMPT) and (1, LM_HYMBA_LONG), in fp32 and fp64: n = 16 below the
    32-row k step and the 64-wide tiles, h = 50."""
    out = []
    if hybrid is not None:
        s = hybrid.ssm
        w = (hybrid.n_ssm_heads, s.head_dim, s.n_groups, s.d_state, s.chunk)
        out = [(b, l) + w + (dt,) for dt in ("float32", "float64")
               for b, l in ((1, LM_PROMPT), (LM_SLOTS, LM_PROMPT),
                            (1, LM_HYMBA_LONG))]
    s = cfg.ssm
    big = [(b, LM_PROMPT, cfg.n_ssm_heads, s.head_dim, s.n_groups, s.d_state,
            s.chunk, "float32") for b in (1, LM_SLOTS)]
    three = [(1, 3 * s.chunk, cfg.n_ssm_heads, s.head_dim, s.n_groups,
              s.d_state, s.chunk, "float32")]
    small = [(2, 64, 4, 8, 2, 16, 16, dt) for dt in ("float32", "float64")]
    small += [(1, 64, 4, 32, 2, 16, 64, dt) for dt in ("float32", "float64")]
    # three chunks over b h = 160 planes (more than the card's 132 SMs),
    # ragged p and n tiles
    small += [(2, 192, 80, 40, 2, 72, 64, dt) for dt in ("float32", "float64")]
    return big + three + small + out


def ssd_inputs(torch, np, b, l, h, p, g, n, dtype, seed, init=False):
    """Numpy-seeded scan inputs on the card: x ~ N(0, 1), ad = -|N(0, 1)|
    * 0.3 (the reference's test distribution), B, C ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, l, h, p)),
            -np.abs(rng.standard_normal((b, l, h))) * 0.3,
            rng.standard_normal((b, l, g, n)), rng.standard_normal((b, l, g, n))]
    if init:
        arrs.append(rng.standard_normal((b, h, p, n)))
    out = [torch.from_numpy(a.astype(dtype)).to(DEVICE) for a in arrs]
    return out[:4], (out[4] if init else None)


def ssd_violation(torch, got, want, dtype: str) -> float:
    """Max abs error of B8 against its plain version; raises where an
    element leaves ``atol + rtol * |want|`` (fp32: atol relative to
    max(1, max|want|))."""
    tol = SSD_TOL[dtype]
    atol = tol * max(1.0, float(want.abs().max())) if dtype == "float32" else tol
    diff = (got - want).abs()
    if bool((diff > atol + tol * want.abs()).any()):
        raise AssertionError(f"B8 vs plain ({dtype}): max abs err "
                             f"{float(diff.max())} beyond atol {atol} + rtol {tol}")
    return float(diff.max())


def compare_ssd(torch, np, ssd_k, cfg, hybrid=None) -> dict:
    """Phase 3 (B8): every case from a zero and a random initial state;
    returns the max abs error of y at each LM's batcher prefill shape (b 1,
    fp32): ``{"lm": ..., "hybrid": ...}``."""
    errs_at = {}
    mains = {"lm": ssd_cases(cfg)[0]}
    if hybrid is not None:
        mains["hybrid"] = ssd_cases(cfg, hybrid)[-6]
    for i, (b, l, h, p, g, n, q, dt) in enumerate(ssd_cases(cfg, hybrid)):
        errs = []
        for init in (False, True):
            (xd, ad, B, C), s0 = ssd_inputs(torch, np, b, l, h, p, g, n, dt,
                                            seed=i, init=init)
            y, f = ssd_k.ssd_fused(xd, ad, B, C, chunk=q, init_state=s0)
            torch.cuda.synchronize()
            y0, f0 = ssd_k.ssd_fused_ref(xd, ad, B, C, chunk=q, init_state=s0)
            errs += [ssd_violation(torch, y, y0, dt),
                     ssd_violation(torch, f, f0, dt)]
        for name, case in mains.items():
            if case == (b, l, h, p, g, n, q, dt):
                errs_at[name] = errs[0]
        phase("compare", f"B8 (b, l, h, p, g, n) = {(b, l, h, p, g, n)} chunk "
              f"{q} {dt}: max abs err y / state {max(errs[0::2]):.3e} / "
              f"{max(errs[1::2]):.3e} (zero and random initial state)")
    return errs_at


def compare_gather(torch, np, gather_k, cfg) -> None:
    """Phase 3 (B9): rows of the LM's table shape, exactly equal, for ids
    of int32 and int64 on the host and on the card; one launch a call.
    Then ids on the card outside ``[0, V)`` (V, V + 7, -1, -V - 3,
    2^31 - 1, and 2^31 as int64): the kernel bounds each by
    ``gather.clamp_ids``'s rule, equal to ``table[clamp_ids(ids)]``, and
    the CUDA context stays usable (a synchronize passes).  Raw
    out-of-range ids never go to ``table[ids]`` on the card: its device
    assert would poison the context."""
    rng = np.random.default_rng(7)
    v, d = cfg.vocab_size, cfg.d_model
    n_cases = n_bound = 0
    for dt in (torch.float32, torch.float64):
        table = torch.randn((v, d), dtype=dt, device=DEVICE)
        for t in GATHER_TS:
            for id_dtype in (np.int32, np.int64):
                host = rng.integers(0, v, t).astype(id_dtype)
                want = gather_k.embedding_gather_ref(table, host)
                for ids in (host, torch.from_numpy(host).to(DEVICE)):
                    before = gather_k.KERNEL_LAUNCHES
                    got = gather_k.embedding_gather(table, ids)
                    torch.cuda.synchronize()
                    if gather_k.KERNEL_LAUNCHES != before + 1:
                        raise AssertionError(
                            f"B9 T={t}: {gather_k.KERNEL_LAUNCHES - before} "
                            "launches for one call")
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"B9 vs table[ids]: T={t} {dt} ids "
                            f"{np.dtype(id_dtype).name} on "
                            f"{getattr(ids, 'device', 'the host')} differ")
                    n_cases += 1
        raw = [v, v + 7, -1, -v - 3, 2**31 - 1, 0, v - 1]
        for id_dtype, extra in ((torch.int32, []), (torch.int64, [2**31, -2**31 - 5])):
            ids = torch.tensor(raw + extra, dtype=id_dtype, device=DEVICE)
            got = gather_k.embedding_gather(table, ids)
            torch.cuda.synchronize()
            if not torch.equal(got, table[gather_k.clamp_ids(ids, v)]):
                raise AssertionError(f"B9 out-of-range {id_dtype} ids on the "
                                     f"card: rows differ from table[clamped]")
            n_bound += 1
        del table
    torch.cuda.synchronize()
    phase("compare", f"B9 ({v}, {d}) table, T in {GATHER_TS}, fp32 and fp64, "
          f"int32 and int64 ids on the host and on the card: {n_cases} cases "
          f"torch.equal to table[ids], one launch each; {n_bound} cases of ids "
          "on the card outside [0, V) (V, V + 7, -1, -V - 3, 2^31 - 1; int64 "
          "also 2^31, -2^31 - 5) torch.equal to table[clamp_ids(ids)], the "
          "context usable after them")


def compare_live_bounds(torch, np, F, G, spmv_k, bfs_k, pr_k) -> None:
    """Phase 3 (B4, B5, B6): live widths handed to the wrappers are bounded
    to ``[0, W]`` inside the kernels.  W + 5 in every warp gives results
    torch.equal to the true widths' (the slots past a warp's last entry are
    PAD); -1 in one warp walks no slot there: its rows read 0 (B6), its
    nodes keep their distances (B4), and the kernels equal the plain path
    handed the same widths (B4 exactly, B5 / B6 within 1e-10, fp32 B6
    1e-4 x max|y|)."""
    n_cases = 0
    for dt, tol in ((np.float64, 1e-10), (np.float32, 1e-4)):
        csr = F.random_csr(4093, 3000, 9.0, seed=6, skew=1.2, dtype=dt)
        cols, vals = F.csr_to_ellpack(csr, c=32).to_device(DEVICE)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal(3000).astype(dt)).to(DEVICE)
        X = torch.from_numpy(rng.standard_normal((3000, 8)).astype(dt)).to(DEVICE)
        live = spmv_k.live_widths(cols)
        over = torch.full_like(live, cols.shape[1] + 5)
        neg = live.clone()
        neg[1] = -1
        for fn, rhs in ((spmv_k.spmv_ell, x), (spmv_k.spmm_ell, X)):
            want = fn(cols, vals, rhs, live_width=live)
            if not torch.equal(fn(cols, vals, rhs, live_width=over), want):
                raise AssertionError(f"B6 {fn.__name__} {np.dtype(dt).name}: "
                                     "widths W + 5 differ from the true widths")
            got = fn(cols, vals, rhs, live_width=neg).cpu()
            plain = fn(cols.cpu(), vals.cpu(), rhs.cpu(), live_width=neg.cpu())
            scale = 1.0 if dt == np.float64 else float(plain.abs().max())
            if got[32:64].any() or max_err(got, plain) > tol * scale:
                raise AssertionError(f"B6 {fn.__name__} {np.dtype(dt).name}: "
                                     "width -1 differs from the plain walk")
            n_cases += 2
    radj = G.rmat_graph(4093, 8, seed=7).transpose().to_device(DEVICE)
    live = bfs_k.ell_live_widths(radj)
    over = torch.full_like(live, radj.shape[1] + 5)
    neg = live.clone()
    neg[2] = -1
    rng = np.random.default_rng(2)
    d = torch.full((4093,), G.INF, dtype=torch.int32, device=DEVICE)
    d[torch.from_numpy(rng.choice(4093, 40, replace=False)).to(DEVICE)] = 0
    contrib = torch.from_numpy(rng.random(4093)).to(DEVICE)
    consts = torch.tensor([0.15 / 4093, 0.85, 1e-5], dtype=torch.float64,
                          device=DEVICE)
    want_b = bfs_k.bfs_step(radj, d, 1, live_width=live)
    want_p = pr_k.pagerank_step(radj, contrib, consts, live_width=live)
    got_b = bfs_k.bfs_step(radj, d, 1, live_width=neg).cpu()
    got_p = pr_k.pagerank_step(radj, contrib, consts, live_width=neg).cpu()
    plain_p = pr_k.pagerank_step(radj.cpu(), contrib.cpu(), consts.cpu(),
                                 live_width=neg.cpu())
    if not (torch.equal(bfs_k.bfs_step(radj, d, 1, live_width=over), want_b)
            and torch.equal(pr_k.pagerank_step(radj, contrib, consts,
                                               live_width=over), want_p)
            and torch.equal(got_b, bfs_k.bfs_step(radj.cpu(), d.cpu(), 1,
                                                  live_width=neg.cpu()))
            and torch.equal(got_b[64:96], d[64:96].cpu())
            and max_err(got_p, plain_p) <= PR_RTOL * float(plain_p.abs().max())):
        raise AssertionError("B4 / B5 with handed live widths W + 5 or -1 "
                             "differ from the documented results")
    torch.cuda.synchronize()
    phase("compare", f"live widths bounded in the kernels: {n_cases + 4} B4 / "
          "B5 / B6 cases (W + 5 torch.equal to the true widths; -1 walks no "
          "slot, equal to the plain path handed the same widths)")


def timed_batcher(torch, serve):
    """``serve.Batcher`` with each admission (a b = 1 prefill) and each
    decode step timed, the card synchronized around it."""

    class TimedBatcher(serve.Batcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.prefill_s, self.decode_s = [], []

        def admit(self, slot, req):
            torch.cuda.synchronize()
            t = time.perf_counter()
            super().admit(slot, req)
            torch.cuda.synchronize()
            self.prefill_s.append(time.perf_counter() - t)

        def execute(self, active):
            torch.cuda.synchronize()
            t = time.perf_counter()
            super().execute(active)
            torch.cuda.synchronize()
            self.decode_s.append(time.perf_counter() - t)

    return TimedBatcher


def lm_path(torch, np, configs, M, serve, ssd_k, gather_k, *, cfg=None,
            name: str = "lm", ctx=None) -> dict:
    """Phase 10: mamba2-2.7b served through the batcher and the engine;
    phase 10b (``name`` "lm-dense", ``cfg`` llama-3.2-3b's): the dense
    attention LM the same way; phase 13 (``name`` "lm-families"): hymba,
    seamless and the vision LM, the engine's prompts with ``ctx`` (the
    stub frontend's output, numpy) as ``ctx_embeds`` where the family takes
    it (the batcher's decode against the caches' zero context, as the
    reference's).  B8 runs in every mamba2 or hymba layer of a prefill and
    never in the other models; B9 once a prefill and once a decode step."""
    cfg = cfg or lm_config(configs)
    smi = smi_line()
    t0 = time.perf_counter()
    params = M.init_params(M.make_generator(LM_SEED, DEVICE), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.parameters())
    phase(name, f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{describe_lm(cfg)}, vocab {cfg.vocab_size}: "
          f"{n_params:,} parameters ({4 * n_params / 1e9:.2f} GB fp32), "
          f"random init (seed {LM_SEED}) in {time.perf_counter() - t0:.1f} s")

    TimedBatcher = timed_batcher(torch, serve)
    rng = np.random.default_rng(LM_SEED)
    prompts = rng.integers(0, cfg.vocab_size,
                           (LM_REQUESTS, LM_PROMPT)).astype(np.int32)
    gcfg = serve.GenerationConfig(max_new_tokens=LM_NEW_TOKENS,
                                  cache_len=LM_PROMPT + LM_NEW_TOKENS)
    batcher = TimedBatcher(cfg, params, n_slots=LM_SLOTS, gcfg=gcfg)
    for rid in range(LM_REQUESTS):
        batcher.submit(serve.Request(rid=rid, prompt=prompts[rid],
                                     max_new_tokens=LM_NEW_TOKENS))
    torch.cuda.synchronize()
    ssd_k.KERNEL_LAUNCHES = 0
    gather_k.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    done = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b8, b9 = ssd_k.KERNEL_LAUNCHES, gather_k.KERNEL_LAUNCHES
    n_tok = sum(len(r.generated) for r in done)
    if len(done) != LM_REQUESTS or any(
            len(r.generated) != LM_NEW_TOKENS
            or not all(0 <= t < cfg.vocab_size for t in r.generated)
            for r in done):
        raise AssertionError("batcher: a request is missing, short or out of "
                             "the vocabulary")
    steps = len(batcher.decode_s)
    per_call = ssd_k.LAUNCHES_PER_CALL if cfg.ssm is not None else 0
    if b8 != LM_REQUESTS * cfg.n_layers * per_call \
            or b9 != LM_REQUESTS + steps:
        raise AssertionError(
            f"batcher launches B8 {b8} (want {LM_REQUESTS} prefills x "
            f"{cfg.n_layers} layers x {per_call} launches a call), B9 {b9} "
            f"(want {LM_REQUESTS} + {steps})")
    prefill_ms = 1e3 * statistics.mean(batcher.prefill_s)
    decode_ms = 1e3 * statistics.mean(batcher.decode_s)

    def spread(times) -> str:
        ms = sorted(1e3 * t for t in times)
        return f"min {ms[0]:.2f} / median {statistics.median(ms):.2f} / max {ms[-1]:.2f}"
    phase(name, f"Batcher(n_slots={LM_SLOTS}): {LM_REQUESTS} requests x "
          f"{LM_PROMPT}-token prompts, {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.2f} tokens/s; prefill {prefill_ms:.2f} ms a request "
          f"(b = 1; {spread(batcher.prefill_s)}), decode {decode_ms:.2f} ms a "
          f"step ({steps} steps of {LM_SLOTS} slots; {spread(batcher.decode_s)})"
          f"; ssd.KERNEL_LAUNCHES={b8}, "
          f"gather.KERNEL_LAUNCHES={b9} | {smi}")
    for r in done[:2]:
        phase(name, f"  request {r.rid}: {r.generated[:8]}...")

    engine = serve.ServeEngine(cfg, params, gcfg)
    torch.cuda.synchronize()
    ssd_k.KERNEL_LAUNCHES = 0
    gather_k.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    out = engine.generate(prompts[:LM_SLOTS], extras=None if ctx is None
                          else {"ctx_embeds": ctx})
    torch.cuda.synchronize()
    eng_wall = time.perf_counter() - t0
    e8, e9 = ssd_k.KERNEL_LAUNCHES, gather_k.KERNEL_LAUNCHES
    if out.shape != (LM_SLOTS, LM_NEW_TOKENS) or out.min() < 0 \
            or out.max() >= cfg.vocab_size:
        raise AssertionError(f"engine: tokens of shape {out.shape} in "
                             f"[{out.min()}, {out.max()}]")
    if e8 != cfg.n_layers * per_call or e9 != LM_NEW_TOKENS:
        raise AssertionError(f"engine launches B8 {e8} (want {cfg.n_layers} "
                             f"x {per_call}), B9 {e9} (want {LM_NEW_TOKENS})")
    by_rid = {r.rid: r.generated for r in done}
    same = sum(out[i].tolist() == by_rid[i] for i in range(LM_SLOTS))
    with_ctx = "" if ctx is None else (
        f" with ctx_embeds {ctx.shape} (the batcher's requests: the zero "
        "context)")
    phase(name, f"ServeEngine.generate ({LM_SLOTS}, {LM_PROMPT}){with_ctx}: "
          f"{out.size} tokens in {eng_wall:.3f} s = {out.size / eng_wall:.2f} "
          f"tokens/s; ssd.KERNEL_LAUNCHES={e8}, gather.KERNEL_LAUNCHES={e9}; "
          f"greedy tokens equal to the batcher's for {same} of {LM_SLOTS} "
          f"prompts (b = 4 against b = 1 prefills: other cuBLAS shapes) | {smi}")
    return {"cfg": cfg, "params": params, "prompts": prompts, "ctx": ctx,
            "launches": {"ssd_fused": b8 + e8, "embedding_gather": b9 + e9},
            "tokens_per_s": n_tok / wall, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "engine_tokens_per_s": out.size / eng_wall}


def check_model(M, nn, params, cfg):
    """The first layers of ``params`` at full width as an LM of their own
    (the card's tensors, no copy) and its config: LM_CHECK_LAYERS blocks (a
    dense first layer counted among them), the enc-dec's first
    LM_CHECK_LAYERS encoder and decoder layers, or the vision stack's first
    group (``every`` self blocks and its cross block)."""
    head = (params.tok_embed, params.final_norm, params.lm_head)
    n = LM_CHECK_LAYERS
    if cfg.encdec is not None:
        cfg2 = dataclasses.replace(cfg, n_layers=n, encdec=dataclasses.replace(
            cfg.encdec, encoder_layers=n))
        return M.LM(*head, None, encoder=nn.ModuleList(list(params.encoder)[:n]),
                    enc_norm=params.enc_norm,
                    decoder=nn.ModuleList(list(params.decoder)[:n])), cfg2
    if params.self_blocks is not None:
        cfg2 = dataclasses.replace(cfg, n_layers=cfg.cross_attn.every)
        return M.LM(*head, None,
                    self_blocks=nn.ModuleList(list(params.self_blocks)[:1]),
                    cross_blocks=nn.ModuleList(list(params.cross_blocks)[:1]),
                    ctx_proj=params.ctx_proj), cfg2
    n_stacked = n - (params.dense0 is not None)
    return (M.LM(*head, nn.ModuleList(list(params.blocks)[:n_stacked]),
                 params.dense0), dataclasses.replace(cfg, n_layers=n))


def lm_check(torch, np, M, lm: dict, label: str = "lm",
             card_scope=contextlib.nullcontext, prompt=None,
             rtol: float = LM_LOGIT_RTOL) -> float:
    """Phases 10 / 10b / 12 / 13: the model's first layers at full width
    (:func:`check_model`) from the same weights on the card (B9; B8 for
    mamba2 and hymba; B1 for a MoE layer's combine, under ``card_scope``)
    and on the CPU (plain versions, the MoE combine on the dense path), on
    ``prompt`` (default: the first of the phase's prompts), with the
    phase's first ``ctx_embeds`` where it has them.  The CPU copy is made
    tensor by tensor from the card's, so the card holds no second copy.
    Where the prompt passes a sliding window, the CPU's caches must show
    the ring wrapped: only the last ``window`` positions kept.  Logits
    within ``rtol`` x max|logit| (the phase 18 bf16 scan: BF16_LOGIT_RTOL).
    Returns the largest logit error over max|logit|."""
    import copy

    from torch import nn

    cfg, params = lm["cfg"], lm["params"]
    card, cfg2 = check_model(M, nn, params, cfg)
    host = copy.deepcopy(card, memo={
        id(t): nn.Parameter(t.detach().cpu(), requires_grad=False)
        for t in card.parameters()})
    prompt = lm["prompts"][:1] if prompt is None else prompt
    s = prompt.shape[1]
    batch = {"tokens": prompt}
    if lm.get("ctx") is not None:
        batch["ctx_embeds"] = lm["ctx"][:1]
    runs = {}
    t0 = time.perf_counter()
    for name, p, dev, scope in (("card", card, DEVICE, card_scope),
                                ("cpu", host, "cpu", contextlib.nullcontext)):
        with scope():
            caches = M.init_caches(cfg2, 1, s + LM_NEW_TOKENS,
                                   dtype=torch.float32, device=dev)
            logits, caches = M.prefill(p, cfg2, batch, caches)
            steps, toks = [logits[:, -1].cpu()], []
            for _ in range(LM_NEW_TOKENS - 1):
                tok = torch.argmax(steps[-1], dim=-1)
                toks.append(int(tok[0]))
                last, caches = M.decode_step(p, cfg2, tok[:, None].numpy(),
                                             caches)
                steps.append(last.cpu())
            toks.append(int(torch.argmax(steps[-1], dim=-1)[0]))
        runs[name] = (logits.cpu(), steps, toks)
    ring = ""
    window = cfg.sliding_window
    if window is not None and s > window:
        kv = caches["layers"].kv
        end = s + LM_NEW_TOKENS - 1
        if kv.k.shape[2] != window or int(kv.length.min()) != end \
                or int(kv.pos.min()) != end - window:
            raise AssertionError(
                f"{label} check: the ring of {kv.k.shape[2]} slots holds "
                f"positions {int(kv.pos.min())} .. {int(kv.pos.max())} after "
                f"{end} tokens (want the last {window})")
        ring = (f"; the ring of {window} slots wrapped (positions "
                f"{int(kv.pos.min())} .. {int(kv.pos.max())} kept)")
    del caches
    (lc, sc, tc), (lh, sh, th) = runs["card"], runs["cpu"]
    scale = float(lh.abs().max())
    tol = rtol * scale
    err = float((lc - lh).abs().max())
    if not err <= tol:
        raise AssertionError(f"{label} check: prefill logits differ by {err} > "
                             f"{rtol} x max|logit| = {tol}")
    top2 = torch.topk(torch.cat(sh), 2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).numpy()[None]
    checked, close = margin_rule(np.array([tc]), np.array([th]), margins, tol,
                                 label=f"{label} check")
    for _, i in checked:
        step_err = float((sc[i] - sh[i]).abs().max())
        if not step_err <= tol:
            raise AssertionError(f"{label} check: step {i} logits differ by "
                                 f"{step_err} > {tol}")
        err = max(err, step_err)
    checked = len(checked)
    ctx = "" if "ctx_embeds" not in batch else \
        f" with ctx_embeds {batch['ctx_embeds'].shape}"
    phase(label, f"check: {cfg2.n_layers} layers at full width"
          + (f" (and {cfg2.encdec.encoder_layers} encoder layers)"
             if cfg2.encdec is not None else "")
          + f", card vs CPU (plain versions) on a (1, {s}) prompt{ctx}: "
          f"max abs logit err {err:.3e} <= {rtol} x max|logit| "
          f"{scale:.3f}; greedy tokens equal at {checked} of {LM_NEW_TOKENS} "
          f"positions with a top-2 margin above the tolerance; closer margins "
          f"{close}{ring} ({time.perf_counter() - t0:.1f} s)")
    return err / scale


def time_ssd(torch, np, ssd_k, b, l, h, p, g, n, q, flush, goal=None) -> dict:
    """B8 at (b, l, h, p, g, n) chunk q in fp32 (CUDA events, the L2
    flushed) beside its bound (operations; bytes printed beside), the
    form's floor and its plain version; ``goal`` (ms) marked met or
    missed where given."""
    from repro_torch.core import autotune

    (xd, ad, B, C), _ = ssd_inputs(torch, np, b, l, h, p, g, n, "float32",
                                   seed=11)

    def run():
        return ssd_k.ssd_fused(xd, ad, B, C, chunk=q)

    def plain():
        return ssd_k.ssd_fused_ref(xd, ad, B, C, chunk=q)

    got, want = run(), plain()
    torch.cuda.synchronize()
    err = ssd_violation(torch, got[0], want[0], "float32")
    ms = time_ms(torch, run, flush)
    plain_ms = time_ms(torch, plain, flush)
    nbytes = 4 * (2 * b * l * h * p + b * l * h + 2 * b * l * g * n
                  + b * h * p * n)
    flops = autotune.ssd_flops(b, l, h, p, n, q)
    executed = autotune.ssd_flops_executed(b, l, h, p, n, q)
    # the built form: launch 1 on the CUDA cores, launch 3's products
    # 3xTF32 on the tensor cores (three TF32 passes each)
    tc = sum(v for k, v in executed.items() if k != "chunk_state")
    floor_ms = (executed["chunk_state"] / FP32_OPS + 3 * tc / TF32_OPS) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_OPS * 1e3
    met = "" if goal is None else \
        f" (goal <= {goal}: {'met' if ms <= goal else 'missed'})"
    phase("timing", f"B8 ssd_fused (b, l, h, p, g, n) = {(b, l, h, p, g, n)} "
          f"chunk {q} fp32: {ms:.4f} ms in {ssd_k.LAUNCHES_PER_CALL} "
          f"launches{met} | bound {max(bytes_ms, ops_ms):.4f} ms (ops "
          f"{ops_ms:.4f}: {flops / 1e9:.3f} GFLOP; bytes {bytes_ms:.4f}) | the "
          f"form's floor ({sum(executed.values()) / 1e9:.3f} GFLOP executed, "
          + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in executed.items())
          + "; chunk_state on the CUDA cores at 67 TFLOP/s, the rest "
          f"3xTF32, 3 x its flops at 495 TFLOP/s) {floor_ms:.4f} ms | "
          f"plain {plain_ms:.4f} ms | no single PyTorch call | max abs err y "
          f"vs plain {err:.3e} | {flops / ms / 1e6:.1f} GFLOP/s of the function")
    return {"b": b, "ms": ms, "plain_ms": plain_ms, "err": err,
            "shape": f"(b, l, h, p, g, n) = {(b, l, h, p, g, n)} chunk {q} fp32",
            "bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "gflop": flops / 1e9}


def time_lm(torch, np, ssd_k, gather_k, lm: dict, comp_err: float,
            b9_by_path: dict, flush) -> list[dict]:
    """Phase 11 (LM): B8 at the batcher's (b 1) and the engine's (b 4)
    prefill shapes; B9 (:func:`time_gather`), its launches the sum of
    ``b9_by_path`` (each LM path's count from its own run)."""
    cfg = lm["cfg"]
    s = cfg.ssm
    l, h, p, g, n, q = LM_PROMPT, cfg.n_ssm_heads, s.head_dim, s.n_groups, \
        s.d_state, s.chunk
    b8 = [time_ssd(torch, np, ssd_k, b, l, h, p, g, n, q, flush,
                   goal=SSD_GOAL_MS[b]) for b in (1, LM_SLOTS)]
    main = b8[0]
    ssd_rec = {"name": "ssd_fused", "route": "cuda",
               "source": "src/repro_torch/csrc/ssd_fused.cu",
               "replaces": "src/repro/kernels/ssd.py:26",
               "launches": lm["launches"]["ssd_fused"],
               "max_abs_err": max(comp_err, main["err"]), "ms": main["ms"],
               "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
               "bound_by": ("bytes" if main["bytes_ms"] >= main["ops_ms"]
                            else "operations"),
               "library_ms": None,
               "shape": f"(b, l, h, p, g, n) = {(1, l, h, p, g, n)} chunk {q} "
                        "fp32 (a batcher prefill, one layer)",
               "form": "launch 3 (fp32) 3xTF32 mma.sync on the tensor cores, "
                       "launch 1 register micro-tiles on the CUDA cores",
               "b4": {k: b8[1][k] for k in ("ms", "plain_ms", "bound_ms")}}

    table = lm["params"].tok_embed
    gather_rec = time_gather(torch, np, gather_k, table,
                             sum(b9_by_path.values()), flush)
    gather_rec["launches_by_path"] = dict(b9_by_path)
    return [ssd_rec, gather_rec]


def gather_readings(torch, fn, launch, n_sets: int) -> dict:
    """Readings of one way to compute ``table[ids]`` over ``n_sets`` id
    sets: ``host_us``, GATHER_HOST_CALLS calls of ``fn(i)`` on the host
    clock, one synchronize at the end, over the count; where ``launch`` is
    given, ``launch_ms``, one CUDA-event pair around GATHER_LAUNCH_REPS
    back-to-back calls of ``launch(i)``, over the count, and ``kernel_us``,
    the device time a call of the same loop under ``torch.profiler`` (its
    device-side events; None where it shows none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(n_sets):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(GATHER_HOST_CALLS):
        fn(i % n_sets)
    torch.cuda.synchronize()
    out = {"host_us": (time.perf_counter() - t0) / GATHER_HOST_CALLS * 1e6}
    if launch is None:
        return out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(GATHER_LAUNCH_REPS):
        launch(i % n_sets)
    end.record()
    torch.cuda.synchronize()
    out["launch_ms"] = start.elapsed_time(end) / GATHER_LAUNCH_REPS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(GATHER_LAUNCH_REPS):
            launch(i % n_sets)
        torch.cuda.synchronize()
    dev_us = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    out["kernel_us"] = dev_us / GATHER_LAUNCH_REPS if dev_us > 0 else None
    return out


def time_gather(torch, np, gather_k, table, launches: int, flush) -> dict:
    """Phase 11 (B9): on the model's table at a decode step's (4), a
    prefill's (512) and the engine's (4 x 512) ids, GATHER_ID_SETS id sets
    each: the wrapper's time (``time_ms``: the host work of a call and its
    kernel, L2 flushed), a launch alone and the host time a call
    (:func:`gather_readings`), for int64 ids on the card (the engine's
    argmax) and int32 ids on the host (the batcher's), beside
    ``F.embedding`` on the same ids (uploaded first where they are on the
    host)."""
    from repro_torch.core.autotune import gather_grid

    from torch.profiler import ProfilerActivity, profile

    embed = torch.nn.functional.embedding
    v, d = table.shape
    # the first profiler run in a process pays the tracer's set-up and may
    # record no device event: pay it here
    with profile(activities=[ProfilerActivity.CUDA]):
        embed(torch.zeros(1, dtype=torch.int64, device=DEVICE), table)
        torch.cuda.synchronize()
    rows = {}
    for t in (LM_PROMPT, LM_SLOTS, LM_SLOTS * LM_PROMPT):
        rng = np.random.default_rng(t)
        host = [rng.integers(0, v, t).astype(np.int32)
                for _ in range(GATHER_ID_SETS)]
        dev = [torch.from_numpy(h.astype(np.int64)).to(DEVICE) for h in host]
        outs = [torch.empty((t, d), dtype=table.dtype, device=DEVICE)
                for _ in host]
        chunks, threads = gather_grid(t, d * table.element_size())
        for h, ids in zip(host, dev):
            got = gather_k.embedding_gather(table, ids)
            if not (torch.equal(got, gather_k.embedding_gather_ref(table, ids))
                    and torch.equal(got, embed(ids, table))
                    and torch.equal(got, gather_k.embedding_gather(table, h))):
                raise AssertionError(f"B9 at T={t}: not equal to table[ids]")
        ours = gather_readings(
            torch, lambda i: gather_k.embedding_gather(table, dev[i]),
            lambda i: gather_k._launch(table, dev[i], outs[i], chunks, threads),
            GATHER_ID_SETS)
        lib = gather_readings(torch, lambda i: embed(dev[i], table),
                              lambda i: embed(dev[i], table), GATHER_ID_SETS)
        ours_host = gather_readings(
            torch, lambda i: gather_k.embedding_gather(table, host[i]), None,
            GATHER_ID_SETS)["host_us"]
        lib_host = gather_readings(
            torch, lambda i: embed(torch.from_numpy(host[i]).to(DEVICE), table),
            None, GATHER_ID_SETS)["host_us"]
        rec = {
            "ms": time_ms(torch, lambda: gather_k.embedding_gather(table, dev[0]), flush),
            "plain_ms": time_ms(torch, lambda: gather_k.embedding_gather_ref(table, dev[0]), flush),
            "library_ms": time_ms(torch, lambda: embed(dev[0], table), flush),
            "launch_ms": ours["launch_ms"], "kernel_us": ours["kernel_us"],
            "host_us": ours["host_us"],
            "library_launch_ms": lib["launch_ms"],
            "library_kernel_us": lib["kernel_us"],
            "library_host_us": lib["host_us"],
            "host_ids_ms": time_ms(torch, lambda: gather_k.embedding_gather(table, host[0]), flush),
            "host_ids_host_us": ours_host,
            "library_host_ids_ms": time_ms(
                torch, lambda: embed(torch.from_numpy(host[0]).to(DEVICE), table), flush),
            "library_host_ids_host_us": lib_host,
            # each gathered row read and written once, each int64 id read once
            "bound_ms": (2 * t * d * table.element_size() + 8 * t)
            / HBM_BYTES_PER_S * 1e3,
            "grid": [t, chunks], "threads": threads}
        rows[t] = rec

        def us(x):
            return "not measured" if x is None else f"{x:.2f} us"
        phase("timing", f"B9 embedding_gather T={t} from ({v}, {d}) fp32, "
              f"grid ({t}, {chunks}) x {threads}: int64 ids on the card: "
              f"wrapper {rec['ms']:.4f} ms | launch alone "
              f"{rec['launch_ms']:.4f} ms (kernel {us(rec['kernel_us'])}) | "
              f"host {rec['host_us']:.2f} us a call | bound "
              f"{rec['bound_ms']:.5f} ms (bytes) | plain {rec['plain_ms']:.4f}"
              f" ms || F.embedding: {rec['library_ms']:.4f} ms | launch alone "
              f"{rec['library_launch_ms']:.4f} ms (kernel "
              f"{us(rec['library_kernel_us'])}) | host "
              f"{rec['library_host_us']:.2f} us a call || int32 ids on the "
              f"host: wrapper {rec['host_ids_ms']:.4f} ms, host "
              f"{ours_host:.2f} us a call | upload + F.embedding "
              f"{rec['library_host_ids_ms']:.4f} ms, {lib_host:.2f} us a call")
    main = rows[LM_PROMPT]
    return {"name": "embedding_gather", "route": "cuda",
            "source": "src/repro_torch/csrc/embedding_gather.cu",
            "replaces": "src/repro/kernels/gather.py:24",
            "launches": launches, "max_abs_err": 0.0,
            "bound_by": "bytes",
            **{k: main[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "launch_ms",
                "host_us", "library_launch_ms", "library_host_us",
                "kernel_us", "library_kernel_us", "host_ids_ms",
                "host_ids_host_us")},
            "shape": f"T={LM_PROMPT} int64 ids on the card from ({v}, {d}) "
                     "fp32 (a prefill's tokens)",
            "other_t": {str(t): {k: r[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "launch_ms",
                "host_us", "library_launch_ms", "library_host_us")}
                for t, r in rows.items() if t != LM_PROMPT}}


# ---------------------------------------------------------------------------
# The MoE LM path: the combine on B1 through the kernel service
# ---------------------------------------------------------------------------


def margin_rule(got, want, margins, tol: float,
                label: str = "lm-moe") -> tuple[list, list]:
    """The greedy-token rule on (rows, steps) token grids: ``got`` equals
    ``want`` wherever the top-2 margin that chose ``want`` exceeds
    ``tol``; a closer margin is reported and, where the tokens differ,
    ends its row's check (the continuations part there).  Returns the
    positions checked and the close ones."""
    checked, close = [], []
    for r in range(want.shape[0]):
        for c in range(want.shape[1]):
            if margins[r, c] <= tol:
                close.append((r, c, float(margins[r, c])))
                if got[r, c] != want[r, c]:
                    break
                continue
            if got[r, c] != want[r, c]:
                raise AssertionError(
                    f"{label}: token ({r}, {c}) {got[r, c]} against "
                    f"{want[r, c]} (margin {margins[r, c]} > {tol})")
            checked.append((r, c))
    return checked, close


def lm_moe_path(torch, np, configs, M, serve, moe, sell_core, gather_k, ops,
                KernelRegistry, KernelService) -> dict:
    """Phase 12: deepseek-moe-16b at full width on the card, served by the
    plain engine (the MoE combines on the dense path, B9 for the tokens)
    and by the fused engine (every combine a ``moe_dispatch`` request on a
    float32 envelope of the service: kernel B1), on the same (LM_SLOTS,
    LM_PROMPT) prompts.  The fused run counts B1's launches combine by
    combine (``ops.moe_dispatch`` wrapped where the service calls it), and
    its first prefill and decode combines give the timing phase its two
    B1 shapes."""
    cfg = lm_moe_config(configs)
    m = cfg.moe
    n_moe = cfg.n_layers - (1 if cfg.dense_first_layer_ff else 0)
    smi = smi_line()
    free, total = torch.cuda.mem_get_info()
    phase("lm-moe", f"device memory before init: {free / 1e9:.2f} GB free of "
          f"{total / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(M.make_generator(LM_SEED, DEVICE), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.parameters())
    phase("lm-moe", f"{cfg.name}: {cfg.n_layers} layers (a dense first layer, "
          f"then {n_moe} MoE), d_model {cfg.d_model}, {describe_lm(cfg)}, "
          f"vocab {cfg.vocab_size}: {n_params:,} parameters "
          f"({4 * n_params / 1e9:.2f} GB fp32), random init (seed {LM_SEED}) "
          f"on the card in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated (the "
          f"config's estimate ModelConfig.n_params: {cfg.n_params():,})")

    rng = np.random.default_rng(LM_SEED)
    prompts = rng.integers(0, cfg.vocab_size,
                           (LM_SLOTS, LM_PROMPT)).astype(np.int32)
    gcfg = serve.GenerationConfig(max_new_tokens=LM_NEW_TOKENS,
                                  cache_len=LM_PROMPT + LM_NEW_TOKENS)
    cap = int(LM_PROMPT * m.top_k / m.n_experts * m.capacity_factor) + 1
    reg = KernelRegistry(device=DEVICE)
    reg.register_moe("deepseek", n_tokens=LM_SLOTS * LM_PROMPT,
                     n_slots=LM_SLOTS * m.n_experts * cap, d_model=cfg.d_model,
                     top_k=m.top_k, dtype="float32")
    svc = KernelService(reg, n_slots=N_SLOTS)
    engines = {"plain": serve.ServeEngine(cfg, params, gcfg),
               "fused": serve.ServeEngine(cfg, params, gcfg, kernel_service=svc,
                                          moe_operand="deepseek")}
    runs, combines, shapes = {}, [], {}
    dispatch = ops.moe_dispatch

    def counted(csr, x, **kw):
        """The service's combine launch, its B1 launches noted."""
        before = sell_core.KERNEL_LAUNCHES
        y = dispatch(csr, x, **kw)
        what = "prefill" if csr.n_rows > LM_SLOTS else "decode"
        combines.append((what, sell_core.KERNEL_LAUNCHES - before))
        shapes.setdefault(what, (csr, x))
        return y

    for name, engine in engines.items():
        # on a service of its own: a two-token warm-up (the first call of
        # each GEMM shape and the allocator's growth stay out of the
        # readings), then a one-token run, the first token's time
        side = (dict(kernel_service=KernelService(reg, n_slots=N_SLOTS),
                     moe_operand="deepseek") if engine.fused else {})
        first = []
        for n_new in (2, 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve.ServeEngine(cfg, params, dataclasses.replace(
                gcfg, max_new_tokens=n_new), **side).generate(prompts)
            torch.cuda.synchronize()
            first.append(1e3 * (time.perf_counter() - t0))
        sell_core.KERNEL_LAUNCHES = 0
        gather_k.KERNEL_LAUNCHES = 0
        moe.ROUTING_READS = 0
        ops.moe_dispatch = counted if engine.fused else dispatch
        try:
            t0 = time.perf_counter()
            out = engine.generate(prompts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ops.moe_dispatch = dispatch
        runs[name] = dict(out=out, wall=wall, b1=sell_core.KERNEL_LAUNCHES,
                          b9=gather_k.KERNEL_LAUNCHES, reads=moe.ROUTING_READS,
                          stats=dict(svc.stats), first_ms=first[1])
        if out.shape != (LM_SLOTS, LM_NEW_TOKENS) or out.min() < 0 \
                or out.max() >= cfg.vocab_size:
            raise AssertionError(f"{name} engine: tokens of shape {out.shape} "
                                 f"in [{out.min()}, {out.max()}]")
        if gather_k.KERNEL_LAUNCHES != LM_NEW_TOKENS:
            raise AssertionError(f"{name} engine: B9 launches "
                                 f"{gather_k.KERNEL_LAUNCHES} != {LM_NEW_TOKENS}")
    hist = svc.metrics.get("latency_us_class_lm_token")
    plain, fused = runs["plain"], runs["fused"]
    want_launches = n_moe * LM_NEW_TOKENS
    if plain["b1"] or plain["reads"]:
        raise AssertionError(f"plain engine: B1 {plain['b1']}, routing reads "
                             f"{plain['reads']} (want 0: the dense path)")
    # B1 counted combine by combine: each combine launched it, and the
    # combines' launches are the whole run's
    b1_by = {w: [n for v, n in combines if v == w] for w in ("prefill", "decode")}
    if fused["stats"]["moe_dispatch_launches"] != want_launches \
            or fused["reads"] != want_launches \
            or hist.count != LM_NEW_TOKENS \
            or fused["stats"]["failed"] or fused["stats"]["served"] != want_launches \
            or len(b1_by["prefill"]) != n_moe \
            or len(b1_by["decode"]) != n_moe * (LM_NEW_TOKENS - 1) \
            or min(n for _, n in combines) < 1 \
            or sum(n for _, n in combines) != fused["b1"]:
        raise AssertionError(
            f"fused engine: stats {fused['stats']}, routing reads "
            f"{fused['reads']}, B1 {fused['b1']} over {len(combines)} combines "
            f"(prefill {b1_by['prefill']}, decode {b1_by['decode']}), token "
            f"latencies {hist.count} (want {want_launches} launches and reads,"
            f" {n_moe} prefill and {n_moe * (LM_NEW_TOKENS - 1)} decode "
            f"combines each launching B1, {LM_NEW_TOKENS} tokens)")
    token_us = (hist.count, hist.mean, hist.max)

    # the plain path driven directly along the plain engine's tokens: its
    # top-2 margins (the token rule) and its prefill / decode times
    caches = M.init_caches(cfg, LM_SLOTS, gcfg.cache_len, dtype=torch.float32,
                           device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = M.prefill(params, cfg, {"tokens": prompts}, caches)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    scale = float(logits.abs().max())
    last, margins, step_s = logits[:, -1], [], []
    for i in range(LM_NEW_TOKENS):
        top2 = torch.topk(last, 2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
        if i + 1 < LM_NEW_TOKENS:
            tok = torch.from_numpy(plain["out"][:, i:i + 1].astype(np.int64))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, caches = M.decode_step(params, cfg, tok.to(DEVICE), caches)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    del logits, last, caches
    margins = np.stack(margins, 1)
    tol = LM_LOGIT_RTOL * scale
    checked, close = margin_rule(fused["out"], plain["out"], margins, tol)
    checked = len(checked)
    decode_ms = 1e3 * statistics.median(step_s)

    for name, r in runs.items():
        r["decode_ms"] = (1e3 * r["wall"] - r["first_ms"]) / (LM_NEW_TOKENS - 1)
        phase("lm-moe", f"{name} ServeEngine.generate ({LM_SLOTS}, {LM_PROMPT})"
              f": {r['out'].size} tokens in {r['wall']:.3f} s = "
              f"{r['out'].size / r['wall']:.2f} tokens/s; first token "
              f"(prefill + sample, a one-token generate) {r['first_ms']:.2f} "
              f"ms, then {r['decode_ms']:.2f} ms a decode step; "
              f"sell_core.KERNEL_LAUNCHES={r['b1']}, "
              f"gather.KERNEL_LAUNCHES={r['b9']}, routing reads {r['reads']}"
              f" | {smi}")
    phase("lm-moe", f"fused: moe_dispatch_launches="
          f"{fused['stats']['moe_dispatch_launches']} ({n_moe} MoE layers x "
          f"{LM_NEW_TOKENS} steps), latency_us_class_lm_token count "
          f"{token_us[0]} (mean {token_us[1] / 1e3:.2f} ms, max "
          f"{token_us[2] / 1e3:.2f} ms); tokens equal to the plain engine's at "
          f"{checked} of {plain['out'].size} positions with a top-2 margin "
          f"above {LM_LOGIT_RTOL} x max|logit| = {tol:.3e}; closer margins "
          f"{close}")
    phase("lm-moe", f"plain path driven directly: prefill ({LM_SLOTS}, "
          f"{LM_PROMPT}) {prefill_ms:.2f} ms, decode step {decode_ms:.2f} ms "
          f"(median of {len(step_s)}; floor: {4 * n_params / 1e9:.2f} GB of "
          f"weights at {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
          f"{4 * n_params / HBM_BYTES_PER_S * 1e3:.2f} ms)")
    phase("lm-moe", "fused: B1 launches by combine: " + "; ".join(
        f"{w} {sum(n)} over {len(n)} combines ({sorted(set(n))} a combine; "
        f"the first {shapes[w][0].n_rows} tokens x {shapes[w][0].n_cols} "
        f"slots, nnz {shapes[w][0].nnz})" for w, n in b1_by.items())
          + f"; together {fused['b1']} = sell_core.KERNEL_LAUNCHES")
    return {"cfg": cfg, "params": params, "prompts": prompts, "runs": runs,
            "shapes": shapes, "b1_by": b1_by,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def time_moe_lm(torch, np, sell_core, ml: dict, flush) -> list[dict]:
    """Phase 12 (timing): B1 at the MoE LM's two routing shapes (the first
    MoE layer's prefill and decode combines) beside its bound, the plain
    version and ``torch.sparse.mm``; ``launches`` the fused engine's B1
    launches on its combines of that kind."""
    from repro_torch.service.registry import moe_k_block
    from repro_torch.sparse import formats as F

    out = []
    for what, (csr, x) in ml["shapes"].items():
        cols, vals, rows = F.csr_to_sell_slabs(csr, c=32).to_device(DEVICE)
        kb = moe_k_block(x.shape[1], "float32")
        a_lib = sparse_csr(torch, np, csr)

        def run():
            return sell_core.spmm_sell(cols, vals, rows, x, n_rows=csr.n_rows,
                                       k_block=kb)

        def plain():
            return sell_core.spmm_sell_ref(cols, vals, rows, x,
                                           n_rows=csr.n_rows)

        def library():
            return torch.sparse.mm(a_lib, x)

        y, yp, yl = run(), plain(), library()
        torch.cuda.synchronize()
        err = max_err(y, yp)
        tol = 1e-4 * max(1.0, float(yp.abs().max()))
        if not max(err, max_err(y, yl)) <= tol:
            raise AssertionError(f"lm-moe {what}: B1 vs plain {err}, vs "
                                 f"sparse.mm {max_err(y, yl)} > {tol}")
        ms = time_ms(torch, run, flush)
        plain_ms = time_ms(torch, plain, flush)
        lib_ms = time_ms(torch, library, flush)
        k = x.shape[1]
        x_rows = touched_columns(np, csr.indices, csr.n_cols)
        # fp32 values and int32 ids once, X's named rows and Y once
        bytes_ms = (8 * csr.nnz + 4 * csr.n_rows + 4 * k * (x_rows
                                                           + csr.n_rows)) \
            / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * csr.nnz * k / FP32_OPS * 1e3
        per = ml["b1_by"][what]
        out.append({
            "name": f"spmm_sell[lm-moe {what}]", "route": "cuda",
            "source": "src/repro_torch/csrc/spmm_sell.cu",
            "replaces": "src/repro/kernels/sell_core.py:93",
            "launches": sum(per), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms,
            "launches_per_combine": sorted(set(per)),
            "shape": f"{csr.n_rows} tokens x {csr.n_cols} slots, nnz "
                     f"{csr.nnz} over {x_rows} slots, k={k} fp32 (the first "
                     f"MoE layer's {what} combine); launches: the fused "
                     f"engine's B1 launches over its {len(per)} {what} "
                     "combines"})
        phase("timing", f"lm-moe {what} combine ({csr.n_rows} x {csr.n_cols}, "
              f"nnz {csr.nnz} over {x_rows} slots, k={k} fp32): B1 {ms:.4f} ms"
              f" | bound {max(bytes_ms, ops_ms):.4f} ms (bytes "
              f"{bytes_ms:.4f}, ops {ops_ms:.4f}) | plain {plain_ms:.4f} ms | "
              f"torch.sparse.mm {lib_ms:.4f} ms | max abs err vs plain "
              f"{err:.3e}")
    return out


def run_lm_moe(torch, np, configs, M, serve, moe, sell_core, gather_k, ops,
               KernelRegistry, KernelService, flush) -> tuple[list[dict], int]:
    """Phase 12 whole: :func:`lm_moe_path`, B1 timed at its two routing
    shapes (:func:`time_moe_lm`), the 2-layer card-vs-CPU check with the
    card's combine on B1, a profiled prefill and decode step on each path,
    and the peak memory.  Returns the two B1 records and the engines' B9
    launches; the model is released on return."""
    ml = lm_moe_path(torch, np, configs, M, serve, moe, sell_core, gather_k,
                     ops, KernelRegistry, KernelService)
    records = time_moe_lm(torch, np, sell_core, ml, flush)
    b1_before = sell_core.KERNEL_LAUNCHES
    lm_check(torch, np, M, ml, label="lm-moe", card_scope=moe.sell_dispatch)
    if sell_core.KERNEL_LAUNCHES == b1_before:
        raise AssertionError("lm-moe check: the card run launched no B1")
    phase("lm-moe", f"check: B1 launched {sell_core.KERNEL_LAUNCHES - b1_before}"
          " times on the card (the MoE layer's combines, SELL path)")
    profile_lm(torch, M, ml)
    profile_lm(torch, M, ml, scope=moe.sell_dispatch, label=" (combine on B1)")
    phase("lm-moe", f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          " GB allocated since the model's init")
    return records, sum(r["b9"] for r in ml["runs"].values())


def lm_families_path(torch, np, configs, M, serve, ssd_k, gather_k,
                     flush) -> dict:
    """Phase 13: the last three LM families at full width on the card, one
    at a time (each freed before the next), random init from LM_SEED:
    hymba-1.5b (B8 in every layer of a prefill, B9), seamless-m4t-medium
    and llama-3.2-vision-11b (B9; the engine's prompts with stub
    ``ctx_embeds``), each through :func:`lm_path` (the batcher, then the
    engine), its card-vs-CPU check (:func:`lm_check`; hymba also on a
    LM_HYMBA_LONG-token prompt, whose ring wraps), a profiled prefill and
    decode step and its peak device memory; B8 timed at hymba's prefill
    shapes.  Returns each arch's B8 and B9 launches and hymba's B8
    readings."""
    out = {"ssd_fused": {}, "embedding_gather": {}, "hymba_b8": None}
    for arch in LM_FAMILY_ARCHS:
        t0 = time.perf_counter()
        cfg = lm_family_config(configs, arch)
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        phase("lm-families", f"{arch}: device memory before init "
              f"{free / 1e9:.2f} GB free of {total / 1e9:.2f} GB")
        torch.cuda.reset_peak_memory_stats()
        lm = lm_path(torch, np, configs, M, serve, ssd_k, gather_k, cfg=cfg,
                     name="lm-families", ctx=family_ctx(np, cfg, LM_SLOTS))
        for k in ("ssd_fused", "embedding_gather"):
            out[k][arch] = lm["launches"][k]
        lm_check(torch, np, M, lm, label="lm-families")
        if cfg.ssm is not None:
            s = cfg.ssm
            out["hymba_b8"] = (arch, [time_ssd(
                torch, np, ssd_k, b, LM_PROMPT, cfg.n_ssm_heads, s.head_dim,
                s.n_groups, s.d_state, s.chunk, flush) for b in (1, LM_SLOTS)])
        if cfg.sliding_window is not None:
            rng = np.random.default_rng(LM_SEED + 1)
            before = ssd_k.KERNEL_LAUNCHES
            lm_check(torch, np, M, lm, label="lm-families",
                     prompt=rng.integers(0, cfg.vocab_size, (1, LM_HYMBA_LONG))
                     .astype(np.int32))
            if cfg.ssm is not None and ssd_k.KERNEL_LAUNCHES == before:
                raise AssertionError("lm-families: the long check's card "
                                     "prefill launched no B8")
        profile_lm(torch, M, lm)
        phase("lm-families", f"{arch}: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated "
              f"since its init; done in {time.perf_counter() - t0:.1f} s")
        del lm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def add_families(kernels: list[dict], fam: dict, comp_err: float) -> None:
    """The families phase's B8 and B9 launches on the kernels line, by
    arch under ``launches_by_path``; B8's readings at hymba's prefill
    shapes (b 1 and LM_SLOTS) under ``"hymba"``."""
    for name in ("ssd_fused", "embedding_gather"):
        rec = next(r for r in kernels if r["name"] == name)
        rec.setdefault("launches_by_path", {"lm": rec["launches"]})
        for arch, n in fam[name].items():
            rec["launches_by_path"][arch] = n
            rec["launches"] += n
    if fam["hymba_b8"] is not None:
        arch, (one, four) = fam["hymba_b8"]
        rec = next(r for r in kernels if r["name"] == "ssd_fused")
        rec["hymba"] = {
            "shape": one["shape"] + " (a hymba batcher prefill, one layer)",
            "launches": fam["ssd_fused"][arch],
            "max_abs_err": max(comp_err, one["err"]), "ms": one["ms"],
            "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"],
            "bound_by": ("bytes" if one["bytes_ms"] >= one["ops_ms"]
                         else "operations"),
            "b4": {k: four[k] for k in ("ms", "plain_ms", "bound_ms")}}


# ---------------------------------------------------------------------------
# The paper's sweep study (B4, B5, B6, B7 at each VL; the warm start, B1)
# ---------------------------------------------------------------------------


def study_named_campaigns(C, sweep) -> dict:
    """Phase 11b, step 1: the named campaigns and the paper's two claims on
    ``paper-fig3`` / ``paper-fig5`` (no violations)."""
    t0 = time.perf_counter()
    named = {n: C.run_campaign(n) for n in C.campaign_names()}
    violations = sweep.check_latency_claim(sweep.slowdown_tables(
        sweep.sweep_result_from_campaign(named["paper-fig3"]))) \
        + sweep.check_bandwidth_claim(
            sweep.sweep_result_from_campaign(named["paper-fig5"]))
    phase("study", f"named campaigns {sorted(named)}: "
          f"{sum(r.spec.n_points for r in named.values())} modeled points in "
          f"{time.perf_counter() - t0:.3f} s; paper claims: "
          f"{len(violations)} violation(s)")
    if violations:
        raise AssertionError(f"paper claim violations: {violations}")
    return named


def study_counts(bfs_k, pr_k, spmv_k, fft_k, zero: bool = False) -> dict:
    """The launch counts of B4, B5, B6 and B7 (both forms), read now, or
    first set to 0 (``zero``)."""
    if zero:
        spmv_k.KERNEL_LAUNCHES = spmv_k.SPMM_LAUNCHES = 0
        for counts in (bfs_k.KERNEL_LAUNCHES, pr_k.KERNEL_LAUNCHES,
                       fft_k.KERNEL_LAUNCHES):
            for name in counts:
                counts[name] = 0
    return {"spmv_ell": spmv_k.KERNEL_LAUNCHES,
            "spmm_ell": spmv_k.SPMM_LAUNCHES,
            "bfs_step": bfs_k.KERNEL_LAUNCHES["bfs_step"],
            "bfs_frontier": bfs_k.KERNEL_LAUNCHES["bfs_frontier"],
            "pagerank_step": pr_k.KERNEL_LAUNCHES["pagerank_step"],
            "fft_stockham_block": fft_k.KERNEL_LAUNCHES["fft_stockham_block"],
            "fft_stockham_two_pass":
                fft_k.KERNEL_LAUNCHES["fft_stockham_two_pass"]}


def study_check(torch, np, C, F, bfs_k, pr_k, spmv_k, fft_k, problems,
                outputs, vls) -> None:
    """Phase 11b, step 2's check: each (kernel, vl)'s last timed result
    against its plain version on the card (fp64 SpMV 1e-10, BFS exact,
    PageRank rtol 1e-10, FFT rtol 1e-9 / atol 1e-9 n)."""
    from repro_torch.core.traffic import PAPER_PROBLEMS

    _, (csr, x) = problems["spmv"]
    xd = torch.from_numpy(x).to(DEVICE)
    host = torch.from_numpy(csr.matvec(x))
    _, graph = problems["bfs"]
    radj = graph.transpose().to_device(DEVICE)
    deg = torch.from_numpy(graph.out_degree.astype(np.float64)).to(DEVICE)
    dist = bfs_k.bfs_ref(radj, 0)
    rank = pr_k.pagerank_ref(radj, deg, iters=PAPER_PROBLEMS["pagerank"].pr_iters)
    _, sig = problems["fft"]
    re = torch.from_numpy(sig).to(DEVICE)
    n = re.shape[-1]
    wre, wim = (torch.from_numpy(w).to(DEVICE) for w in fft_k.fft_twiddles(n))
    spectrum = fft_k.fft_stockham_ref(re, torch.zeros_like(re), wre, wim)
    worst = {"spmv": 0.0, "pagerank": 0.0, "fft": 0.0}
    for vl in vls:
        cols, vals = F.csr_to_ellpack(csr, c=vl).to_device(DEVICE)
        want = spmv_k.spmv_ell_ref(cols, vals, xd)[:csr.n_rows]
        got = outputs["spmv", vl]
        err = max(max_err(got, want), max_err(got.cpu(), host))
        if got.shape != want.shape or not err <= 1e-10:
            raise AssertionError(f"study spmv vl={vl}: max abs err {err} "
                                 "against the plain version / CSR matvec")
        worst["spmv"] = max(worst["spmv"], err)
        if not torch.equal(outputs["bfs", vl], dist):
            raise AssertionError(f"study bfs vl={vl}: != the plain drive")
        worst["pagerank"] = max(worst["pagerank"], check_pr(
            f"study pagerank vl={vl}", outputs["pagerank", vl], rank))
        worst["fft"] = max(worst["fft"], check_fft(
            torch, np, f"study fft vl={vl}", outputs["fft", vl], spectrum, n,
            np.float64))
    phase("study", f"{len(outputs)} results vs plain on card: spmv max abs "
          f"err {worst['spmv']:.3e} (also vs host CSR matvec; tol 1e-10), bfs "
          f"equal, pagerank {worst['pagerank']:.3e} (rtol {PR_RTOL}), fft "
          f"{worst['fft']:.3e} (rtol 1e-9 / atol 1e-9 n)")


def study_profile(torch, C, problems, vl: int, us: dict) -> None:
    """Where a study call's time goes: STUDY_PROFILE_CALLS calls per kernel
    at ``vl`` (each followed by a synchronize) under ``torch.profiler``,
    after one unprofiled call; the device's busy time a call (device-side events,
    one stream) against the event-timed µs of ``measure_cuda`` (``us``),
    which span ``ops``' host time too, and the kernels that take most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for kernel in C.KERNELS:
        fn = C.measure_runner(kernel, vl, problems[kernel][1],
                              torch.device(DEVICE))
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(STUDY_PROFILE_CALLS):
                fn()
                torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        calls = STUDY_PROFILE_CALLS
        busy_us = sum(e.device_time_total for e in dev) / calls
        top = sorted(dev, key=lambda e: e.device_time_total, reverse=True)[:3]
        timed = us[kernel][vl]
        share = (f"device busy {busy_us:.2f} µs a call, {100 * busy_us / timed:.1f}% "
                 f"of the event-timed {timed:.2f} µs" if busy_us > 0 else
                 "device time not measured (no device events)")
        phase("study", f"{kernel} at VL {vl}, {calls} calls under the "
              f"profiler: {share}; most device time a call: " + "; ".join(
                  f"{e.key[:40]} {e.device_time_total / calls:.2f} µs "
                  f"x{e.count / calls:g}" for e in top))


def study_warm_start(torch, np, F, G, sell_core, KernelRegistry,
                     KernelService, TuneCache, store_path, machine,
                     problems) -> int:
    """Phase 11b, step 5: a fresh TuneCache warm-started from the store; the
    registry's candidate C and picks against a cold registry's on cage10
    and rmat15; then SpMV requests served on the warm cage10 (B1).
    Returns B1's launches."""
    cache = TuneCache()
    seeded = cache.warm_from_sweeps(str(store_path))
    hint = cache.hint_vl("spmv", machine.name)
    hinted = cache.candidate_vls_for("spmv", machine.name)
    phase("study", f"warm start: {seeded} hints from {store_path.name}; "
          f"{machine.name} hint VL {hint} for every kernel "
          f"{sorted({cache.hint_vl(k, machine.name) for k in ('spmv', 'bfs', 'pagerank', 'fft')})}"
          f" -> candidate C {hinted}")
    _, (cage, _) = problems["spmv"]
    _, graph = problems["bfs"]
    regs = {"cold": KernelRegistry(device=DEVICE),
            "warm": KernelRegistry(device=DEVICE, cache=cache)}
    cands = {}
    for how, reg in regs.items():
        for name, register, operand in (
                ("cage10", reg.register_matrix, cage),
                ("rmat15", reg.register_graph, graph)):
            op = register(name, operand)
            cands[how, name] = sorted({row[0] for row in op.tuned.table})
            phase("study", f"{how} registry {name}: candidate C "
                  f"{cands[how, name]} ({len(op.tuned.table)} (C, sigma) "
                  f"measured) -> C={op.tuned.c} sigma={op.tuned.sigma} pad="
                  f"{op.pad_factor:.4f} in {op.register_us / 1e6:.2f} s")
    for name in ("cage10", "rmat15"):
        if cands["warm", name] != hinted or \
                not len(cands["warm", name]) < len(cands["cold", name]):
            raise AssertionError(f"{name}: the warm start did not narrow the "
                                 f"tune: {cands}")
    reg = regs["warm"]
    svc = KernelService(reg, n_slots=N_SLOTS)
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal(cage.n_cols) for _ in range(STUDY_SPMV_REQUESTS)]
    torch.cuda.synchronize()
    sell_core.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    rids = [svc.submit("spmv", "cage10", x) for x in xs]
    svc.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sell_core.KERNEL_LAUNCHES
    op = reg.get("cage10")
    if launches <= 0 or launches != op.launches * op.slabs.n_buckets:
        raise AssertionError(f"warm cage10: {launches} B1 launches, "
                             f"{op.launches} groups x {op.slabs.n_buckets} "
                             "buckets expected")
    got = torch.stack([svc.poll(r) for r in rids], dim=1)
    arrs = op.device_arrays
    want = sell_core.spmm_sell_ref(
        arrs["cols"], arrs["vals"], arrs["rows"],
        torch.from_numpy(np.stack(xs, axis=1)).to(DEVICE), n_rows=cage.n_rows)
    err = max_err(got, want)
    phase("study", f"warm cage10 (C={op.tuned.c}): {len(rids)} SpMV requests "
          f"in {wall:.4f} s, B1 launches {launches}; results vs plain on card "
          f"max abs err {err:.3e} (tol 1e-10)")
    if svc.stats["served"] != len(rids) or svc.stats["failed"] \
            or not err <= 1e-10:
        raise AssertionError(f"warm cage10: {svc.stats}, err {err}")
    return launches


def study_path(torch, np, F, G, bfs_k, pr_k, spmv_k, fft_k, sell_core,
               KernelRegistry, KernelService) -> dict:
    """Phase 11b: the paper's sweep study on the card.  The named campaigns
    and both claims; ``measure_cuda`` over the four kernels at every paper
    VL (B6, B4, B5, B7 through ``ops``; each result held against its plain
    version on the card; the phase's launches counted; STUDY_PROFILE_CALLS
    calls of each profiled); a user cube over ``h100_machine()`` with
    modeled µs (cycles / freq_mhz) beside the measured µs; both saved to a ``SweepStore`` under ``build/`` and
    reloaded strictly (cubes ``==``); a ``TuneCache`` warm-started from it
    narrowing the registry's tune, and SpMV requests served on B1.
    Returns ``{"launches": kernel -> n, "us": kernel -> {vl: µs}}``."""
    from repro_torch.core import campaign as C
    from repro_torch.core import sweep
    from repro_torch.core.sdv import h100_machine
    from repro_torch.core.traffic import PAPER_PROBLEMS
    from repro_torch.core.vconfig import PAPER_VLS, SCALAR_VL
    from repro_torch.service import TuneCache

    named = study_named_campaigns(C, sweep)

    kernels = C.KERNELS
    t0 = time.perf_counter()
    problems = C.measure_problems(kernels)
    phase("study", "problems built in "
          f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
              f"{k}: {problems[k][0]}" for k in kernels))
    outputs = {}
    torch.cuda.synchronize()
    study_counts(bfs_k, pr_k, spmv_k, fft_k, zero=True)
    t0 = time.perf_counter()
    records = C.measure_cuda(kernels, vls=PAPER_VLS, reps=STUDY_REPS,
                             campaign="h100-study", device=DEVICE,
                             problems=problems, outputs=outputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = study_counts(bfs_k, pr_k, spmv_k, fft_k)
    calls = len(PAPER_VLS) * (C.MEASURE_WARMUP + STUDY_REPS)
    pr_iters = PAPER_PROBLEMS["pagerank"].pr_iters
    want = {"spmv_ell": calls, "spmm_ell": 0,
            "pagerank_step": calls * pr_iters,
            "fft_stockham_block": calls, "fft_stockham_two_pass": 0}
    phase("study", f"measure_cuda: {len(records)} records (4 kernels x "
          f"{len(PAPER_VLS)} VLs, {STUDY_REPS} timed calls each after "
          f"{C.MEASURE_WARMUP}) in "
          f"{wall:.1f} s; launches {json.dumps(launched)}")
    if len(records) != len(kernels) * len(PAPER_VLS) or any(
            launched[k] != v for k, v in want.items()) or \
            launched["bfs_step"] != launched["bfs_frontier"] or \
            launched["bfs_step"] < calls:
        raise AssertionError(f"study: {len(records)} records, launches "
                             f"{launched}, expected {want} and B4 >= {calls}")
    us = {k: {r["vl"]: r["us_per_call"] for r in records if r["kernel"] == k}
          for k in kernels}
    for k in kernels:
        phase("study", f"{k} µs a call at VL " + ", ".join(
            f"{vl}: {t:.2f}" for vl, t in us[k].items())
            + f" ({problems[k][0]})")
    study_check(torch, np, C, F, bfs_k, pr_k, spmv_k, fft_k, problems,
                outputs, PAPER_VLS)
    study_profile(torch, C, problems, max(PAPER_VLS), us)

    machine = h100_machine()
    spec = C.CampaignSpec(
        name="h100-study", kernels=kernels, vls=(SCALAR_VL,) + PAPER_VLS,
        latencies=STUDY_LATENCIES, bandwidths=(C.BW_UNLIMITED,),
        machines=(machine,),
        description="The paper's grid over h100_machine()'s constants, "
                    "with the card's timings of the same problems.")
    study = C.run_campaign(spec)
    study.measured = records
    rows = C.crosscheck_measured(study)
    if len(rows) != len(records):
        raise AssertionError(f"crosscheck joined {len(rows)} of "
                             f"{len(records)} measured records")
    for k in kernels:
        phase("study", f"{k} modeled / measured µs at VL " + ", ".join(
            f"{r['vl']}: {r['modeled_cycles'] / machine.freq_mhz:.2f} / "
            f"{r['measured_us']:.2f}" for r in rows if r["kernel"] == k)
            + f" ({machine.name}, {machine.freq_mhz:.0f} MHz, +0 cycles)")
    li = STUDY_LATENCIES.index(max(STUDY_LATENCIES))
    phase("study", f"modeled cycles at +{STUDY_LATENCIES[li]}: " + "; ".join(
        f"{k} " + ", ".join(f"{vl}: {study.cycles[0, ki, vi, li, 0]:.0f}"
                            for vi, vl in enumerate(spec.vls))
        for ki, k in enumerate(kernels)))

    STUDY_STORE.parent.mkdir(parents=True, exist_ok=True)
    if STUDY_STORE.exists():
        STUDY_STORE.unlink()
    store = C.SweepStore(str(STUDY_STORE))
    for result in (*named.values(), study):
        store.put(result)
    store.save()
    back = C.SweepStore(str(STUDY_STORE), strict=True)
    for result in (*named.values(), study):
        got = back.get(result.spec.name)
        if got.spec != result.spec or not np.array_equal(
                got.cycles, result.cycles) or got.measured != result.measured:
            raise AssertionError(f"store round trip: {result.spec.name}")
    phase("study", f"store {STUDY_STORE} ({STUDY_STORE.stat().st_size} B): "
          f"{back.names()} reloaded strictly, cubes == and records equal")

    b1 = study_warm_start(torch, np, F, G, sell_core, KernelRegistry,
                          KernelService, TuneCache, STUDY_STORE, machine,
                          problems)
    launched["spmm_sell"] = b1
    return {"launches": {k: v for k, v in launched.items() if v},
            "us": us}


def add_study(kernels: list[dict], study: dict) -> None:
    """The study phase's launches (and its µs by VL) on the kernels line:
    added to each kernel's first record, the earlier paths' count kept
    under ``launches_by_path``."""
    by_kernel = {"spmv_ell": "spmv", "bfs_step": "bfs",
                 "pagerank_step": "pagerank", "fft_stockham_block": "fft"}
    for name, n in study["launches"].items():
        rec = next(r for r in kernels if r["name"] == name)
        rec.setdefault("launches_by_path", {"main paths": rec["launches"]})
        rec["launches_by_path"]["study"] = n
        rec["launches"] += n
        if name in by_kernel:
            rec["study_us_by_vl"] = study["us"][by_kernel[name]]


# ---------------------------------------------------------------------------
# The sharded path (B1 and B3 a shard over a mesh) and float32 PageRank
# (B3's and B5's float forms)
# ---------------------------------------------------------------------------


def shard_mesh():
    """The sharded phase's mesh: the card named SHARD_N times."""
    return (DEVICE,) * SHARD_N


def shard_k_block(k: int) -> int:
    """The k tile ``ops`` takes when the spec names none."""
    return min(8, 1 << max(int(k) - 1, 0).bit_length())


def bucket_split(node_split, spmm_split, layout, kt: int, itemsize: int,
                 pagerank: bool) -> bool:
    """Whether B1 (matrix layouts) or B3 (graph layouts; the PageRank or
    the BFS combine) splits any bucket of ``layout`` (SellSlabs /
    ShardedSlabs / SellGraphSlabs / ShardedGraphSlabs) at this tile."""
    if hasattr(layout, "bucket_cols"):
        shapes = [c.shape[-3:] for c in layout.bucket_cols]     # (S, W, C)
        return any(spmm_split(w, c, s, kt, itemsize).parts > 1
                   for s, w, c in shapes)
    shapes = [a.shape[-3:] for a in layout.bucket_adj]          # (S, C, W)
    return any(node_split(w, c, s, kt, itemsize,
                          "pagerank" if pagerank else "bfs").parts > 1
               for s, c, w in shapes)


def agree(torch, what: str, got, want, split: bool, tol: float) -> str:
    """The sharded result against the unsharded port's: ``torch.equal``,
    or, where B1 or B3 splits a bucket of either layout (the parts' sums
    then depend on the slices a bucket has), within ``tol`` x max|want| a
    column.  Returns how it agreed."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if torch.equal(got, want):
        return "torch.equal"
    if not split:
        raise AssertionError(f"{what}: differs from the unsharded port, and "
                             "neither layout splits a bucket")
    g = got.reshape(got.shape[0], -1).double()
    w = want.reshape(want.shape[0], -1).double()
    err = float(((g - w).abs() / w.abs().amax(dim=0).clamp(min=1e-300)).max())
    if not err <= tol:
        raise AssertionError(f"{what}: {err:.3e} x max|y| > {tol}")
    return f"split buckets, {err:.3e} x max|y| (tol {tol})"


def fp32_check(what: str, got, want) -> float:
    """Float32 ranks against their plain version on the card: within
    PR_FP32_TOL x max|rank| a column; returns the worst such ratio."""
    g = got.reshape(got.shape[0], -1).double()
    w = want.reshape(want.shape[0], -1).double()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: dtype or shape differs")
    err = float(((g - w).abs() / w.abs().amax(dim=0)).max())
    if not err <= PR_FP32_TOL:
        raise AssertionError(f"{what}: {err:.3e} x max|rank| > {PR_FP32_TOL}")
    return err


def sharded_counts(sell_core, bfs_k, pr_k, zero: bool = False) -> dict:
    """B1's, B3's (both combines, PageRank in both dtypes) and B5's float
    form's launch counts, read now, or first set to 0 (``zero``)."""
    keys = ("pagerank_step_sell", "pagerank_step_sell_fp32",
            "pagerank_step_fp32")
    if zero:
        sell_core.KERNEL_LAUNCHES = 0
        bfs_k.KERNEL_LAUNCHES["bfs_step_sell"] = 0
        for key in keys:
            pr_k.KERNEL_LAUNCHES[key] = 0
    return {"spmm_sell": sell_core.KERNEL_LAUNCHES,
            "bfs_step_sell": bfs_k.KERNEL_LAUNCHES["bfs_step_sell"],
            **{key: pr_k.KERNEL_LAUNCHES[key] for key in keys}}


def sharded_path(torch, np, sell_core, sell_shard, bfs_k, pr_k, ops,
                 ExecSpec, KernelRegistry, KernelService, reg, big,
                 gm) -> dict:
    """Phase 11c: the sharded drives on a mesh naming the card SHARD_N
    times, and float32 PageRank, as a user drives them (through ``ops``
    and a ``KernelRegistry(mesh=...)`` + ``KernelService``), each
    sharded result against the serial fold and the unsharded port."""
    from repro_torch.core.autotune import node_split, spmm_split

    mesh = shard_mesh()
    t0 = time.perf_counter()
    if torch.cuda.device_count() < 2:
        try:
            ops.spmv(reg.get("cage10").slabs,
                     np.ones(reg.get("cage10").n_cols),
                     spec=ExecSpec(vl=reg.get("cage10").tuned.c, placement=2))
        except ValueError as exc:
            phase("sharded", f"placement=2 on {torch.cuda.device_count()} "
                  f"card(s) raises ValueError: {exc}")
        else:
            raise AssertionError("placement=2 ran on a one-card machine")
    rng = np.random.default_rng(5)
    big_op = reg.get("big")
    slabs = big_op.slabs
    cols, vals, rows = big_op.device_arrays["cols"], \
        big_op.device_arrays["vals"], big_op.device_arrays["rows"]
    n_rows, n_cols = big_op.n, big_op.n_cols
    # ops' own k tile (k_block=None: the power of two covering k, capped
    # at 8), as a user calls it: k = 32 is then RHS-sharded
    specm = ExecSpec(vl=slabs.c, placement=mesh)
    xs = {k: torch.from_numpy(rng.standard_normal((n_cols, k))).to(DEVICE)
          for k in SHARD_KS}
    out = dict(mesh=mesh, xs=xs, big=big_op)
    torch.cuda.synchronize()
    sharded_counts(sell_core, bfs_k, pr_k, zero=True)
    got = {}
    for k, x in xs.items():
        got[k] = (ops.spmv(slabs, x[:, 0], spec=specm)[:, None] if k == 1
                  else ops.spmm(slabs, x, spec=specm))
    torch.cuda.synchronize()
    b1_ops = sharded_counts(sell_core, bfs_k, pr_k)["spmm_sell"]
    sharded = ops._shard_cached(slabs, SHARD_N, None)
    out["sharded"] = sharded
    for k, x in xs.items():
        kb = shard_k_block(k)
        kt = sell_core.k_tile_for(k, kb)
        rhs = sell_core.padded_k(k, kb) >= SHARD_N * kt
        split_rows = any(bucket_split(node_split, spmm_split, layout, kt, 8,
                                      False) for layout in (slabs, sharded))
        fold = (sell_shard.spmm_sell_rhs_sharded(slabs, x, k_block=kb) if rhs
                else sell_shard.spmm_sell_sharded(sharded, x, k_block=kb))
        want = sell_core.spmm_sell(cols, vals, rows, x, n_rows=n_rows,
                                   k_block=kb)
        if not torch.equal(got[k], fold):
            raise AssertionError(f"big k={k}: the mesh path != the serial "
                                 "fold")
        how = agree(torch, f"big k={k}", got[k], want,
                    split_rows and not rhs, SHARD_TOL)
        phase("sharded", f"big k={k} ({'RHS' if rhs else 'row'}-sharded "
              f"through ops): == serial fold; vs unsharded: {how}")
    if b1_ops <= 0:
        raise AssertionError("the sharded SpMM launched B1 no time")
    # the service: a registry with the mesh, SHARD_REQUESTS SpMV requests
    sreg = KernelRegistry(mesh=mesh)
    t1 = time.perf_counter()
    sop = sreg.register_matrix("big", big)
    phase("sharded", f"registered big on the mesh in "
          f"{time.perf_counter() - t1:.1f} s: mode {sop.mode}, C={sop.tuned.c} "
          f"k_block={sop.tuned.k_block}, {sop.sharded.n_shards} shards, "
          f"window_cols {sop.sharded.window_cols}, plan "
          f"{sop.plans['spmv'].kernel} ({sop.plans['spmv'].n_launches} blocks)")
    svc = KernelService(sreg, n_slots=N_SLOTS)
    xr = [rng.standard_normal(n_cols) for _ in range(SHARD_REQUESTS)]
    before = sell_core.KERNEL_LAUNCHES
    rids = [svc.submit("spmv", "big", x) for x in xr]
    svc.drain()
    torch.cuda.synchronize()
    b1_svc = sell_core.KERNEL_LAUNCHES - before
    if svc.stats["sharded_launches"] != 1 or svc.stats["served"] != \
            SHARD_REQUESTS or b1_svc <= 0:
        raise AssertionError(f"service on the mesh: {dict(svc.stats)}, "
                             f"B1 launches {b1_svc}")
    ys = torch.stack([svc.poll(r) for r in rids], dim=1)
    xstack = torch.from_numpy(np.stack(xr, axis=1)).to(DEVICE)
    want = sell_core.spmm_sell(*(sop.device_arrays[a] for a in
                                 ("cols", "vals", "rows")), xstack,
                               n_rows=n_rows, k_block=sop.tuned.k_block)
    fold = sell_shard.spmm_sell_sharded(sop.sharded, xstack,
                                        k_block=sop.tuned.k_block)
    if not torch.equal(ys, fold):
        raise AssertionError("service on the mesh != the serial fold")
    kt = sell_core.k_tile_for(SHARD_REQUESTS, sop.tuned.k_block)
    split = any(bucket_split(node_split, spmm_split, layout, kt, 8, False)
                for layout in (sop.slabs, sop.sharded))
    phase("sharded", f"service: {SHARD_REQUESTS} SpMV requests on big, "
          f"sharded_launches {svc.stats['sharded_launches']}, B1 launches "
          f"{b1_svc}: == serial fold; vs unsharded: "
          + agree(torch, "service big", ys, want, split, SHARD_TOL))
    out["service_big"] = sop
    del sreg, svc, sop
    # graphs: BFS and PageRank (fp64, fp32) at k = 32 through ops, the
    # serial fold and the service
    sources = {}
    for name in ("uniform21", "rmat15"):
        g = gm["graphs"][name]
        op = gm["reg"].get(name)
        t = op.tuned
        n = g.n_nodes
        arrs = op.device_arrays
        src = gm["results"][name]["sources"]
        sources[name] = src
        spec = ExecSpec(layout="sell", vl=t.c, sigma=t.sigma, placement=mesh)
        d_mesh = ops.bfs(g, src, spec=spec)
        sg, _ = ops._sharded_graph(g, spec, mesh, ops.plan_bfs_ell)
        out[f"sg_{name}"] = sg
        d_fold = sell_shard.bfs_sell_sharded(sg, src, device=DEVICE)
        d_one = bfs_k.bfs_sell(arrs["adj"], arrs["nodes"], n, src)
        if not (torch.equal(d_mesh, d_fold) and torch.equal(d_mesh, d_one)):
            raise AssertionError(f"{name}: sharded BFS != fold / unsharded")
        line = [f"{name} ({SHARD_N} shards, union widths {list(sg.widths)}, "
                f"slices a shard {list(sg.slices_per_shard)}): BFS k=32 == "
                "serial fold == unsharded"]
        for dtype in (torch.float64, torch.float32):
            r_mesh = ops.pagerank(g, damping=SHARD_DAMPINGS, iters=ITERS,
                                  spec=spec, dtype=dtype)
            r_fold = sell_shard.pagerank_sell_sharded(
                sg, arrs["out_degree"], damping=SHARD_DAMPINGS, iters=ITERS,
                dtype=dtype, device=DEVICE)
            r_one = pr_k.pagerank_sell(arrs["adj"], arrs["nodes"],
                                       arrs["out_degree"], n,
                                       damping=SHARD_DAMPINGS, iters=ITERS,
                                       dtype=dtype)
            if not torch.equal(r_mesh, r_fold):
                raise AssertionError(f"{name} {dtype}: mesh != serial fold")
            isz = 8 if dtype == torch.float64 else 4
            split = bucket_split(node_split, spmm_split, op.slabs,
                                 sell_core.node_k_tile(32), isz, True) or \
                bucket_split(node_split, spmm_split, sg,
                             sell_core.node_k_tile(32), isz, True)
            how = agree(torch, f"{name} PageRank {dtype}", r_mesh, r_one,
                        split, PR_RTOL if isz == 8 else SHARD_FP32_TOL)
            line.append(f"PageRank {str(dtype)[6:]} == serial fold, vs "
                        f"unsharded: {how}")
        phase("sharded", "; ".join(line))
    # the service on the mesh: 32 BFS, 32 fp64 and 32 fp32 PageRank
    # requests a graph
    greg = KernelRegistry(cache=gm["reg"].cache, mesh=mesh)
    svc = KernelService(greg, n_slots=N_SLOTS)
    rids = {}
    for name in ("uniform21", "rmat15"):
        greg.register_graph(name, gm["graphs"][name])
        rids[name] = (
            [svc.submit("bfs", name, None, source=s) for s in sources[name]],
            [svc.submit("pagerank", name, None, damping=d, iters=ITERS)
             for d in SHARD_DAMPINGS],
            [svc.submit("pagerank", name, None, damping=d, iters=ITERS,
                        dtype="float32") for d in SHARD_DAMPINGS])
    svc.drain()
    torch.cuda.synchronize()
    if svc.stats["sharded_launches"] != 6 or svc.stats["failed"]:
        raise AssertionError(f"graph service on the mesh: {dict(svc.stats)}")
    for name in ("uniform21", "rmat15"):
        op, sop = gm["reg"].get(name), greg.get(name)
        arrs = op.device_arrays
        n = gm["graphs"][name].n_nodes
        d = torch.stack([svc.poll(r) for r in rids[name][0]], dim=1)
        if not torch.equal(d, bfs_k.bfs_sell(arrs["adj"], arrs["nodes"], n,
                                             sources[name])):
            raise AssertionError(f"{name}: service sharded BFS != unsharded")
        hows = []
        for i, dtype in ((1, torch.float64), (2, torch.float32)):
            r = torch.stack([svc.poll(x) for x in rids[name][i]], dim=1)
            fold = sell_shard.pagerank_sell_sharded(
                sop.sharded, arrs["out_degree"], damping=SHARD_DAMPINGS,
                iters=ITERS, dtype=dtype, device=DEVICE)
            if not torch.equal(r, fold):
                raise AssertionError(f"{name}: service {dtype} != fold")
            isz = 8 if dtype == torch.float64 else 4
            split = bucket_split(node_split, spmm_split, op.slabs,
                                 sell_core.node_k_tile(32), isz, True) or \
                bucket_split(node_split, spmm_split, sop.sharded,
                             sell_core.node_k_tile(32), isz, True)
            hows.append(f"{str(dtype)[6:]} " + agree(
                torch, f"service {name} {dtype}", r, pr_k.pagerank_sell(
                    arrs["adj"], arrs["nodes"], arrs["out_degree"], n,
                    damping=SHARD_DAMPINGS, iters=ITERS, dtype=dtype), split,
                PR_RTOL if isz == 8 else SHARD_FP32_TOL))
        phase("sharded", f"service {name}: 32 BFS == unsharded; PageRank "
              "== serial fold, vs unsharded: " + "; ".join(hows))
    stats = dict(svc.stats)
    del greg, svc
    # float32 PageRank alone: both layouts through ops, against the plain
    # drives on the card
    fp32 = {}
    for name in ("uniform21", "rmat15"):
        g = gm["graphs"][name]
        op = gm["reg"].get(name)
        arrs = op.device_arrays
        n = g.n_nodes
        sell = ExecSpec(layout="sell", vl=op.tuned.c, sigma=op.tuned.sigma,
                        device=DEVICE)
        ell = ExecSpec(layout="ell", device=DEVICE)
        r_sell = ops.pagerank(g, damping=SHARD_DAMPINGS, iters=ITERS,
                              spec=sell, dtype=torch.float32)
        r_ell = ops.pagerank(g, damping=DAMPINGS[0], iters=ITERS, spec=ell,
                             dtype=torch.float32)
        spec, device = ops._graph_spec(sell)
        _, (adj, nodes), deg = ops._prepared_graph(g, spec, device,
                                                   ops.plan_pagerank_ell)
        radj = ops._prepared_graph(g, ell, device,
                                   ops.plan_pagerank_ell)[1][0]
        e_sell = fp32_check(f"{name} B3 fp32 drive", r_sell,
                            pr_k.pagerank_sell_ref(
                                adj, nodes, deg, n, damping=SHARD_DAMPINGS,
                                iters=ITERS, dtype=torch.float32))
        e_ell = fp32_check(f"{name} B5 fp32 drive", r_ell, pr_k.pagerank_ref(
            radj, deg, damping=DAMPINGS[0], iters=ITERS, dtype=torch.float32))
        fp32[name] = (e_sell, e_ell)
        phase("sharded", f"{name}: ops.pagerank float32, sell k=32 (B3) "
              f"{e_sell:.3e} and ell (B5) {e_ell:.3e} x max|rank| from the "
              f"plain drives (tol {PR_FP32_TOL})")
    torch.cuda.synchronize()
    counts = sharded_counts(sell_core, bfs_k, pr_k)
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the sharded path launched no "
                             f"time: {counts}")
    phase("sharded", f"launches in the phase's drives: {json.dumps(counts)}"
          f"; graph service stats {json.dumps(stats)}; path done in "
          f"{time.perf_counter() - t0:.1f} s")
    if torch.cuda.device_count() >= 2:
        two = ops.spmm(slabs, xs[SHARD_KS[1]],
                       spec=ExecSpec(vl=slabs.c, placement=2))
        same = ops.spmm(slabs, xs[SHARD_KS[1]], spec=ExecSpec(
            vl=slabs.c, placement=(DEVICE,) * 2))
        if not torch.equal(two, same):
            raise AssertionError("placement=2 on two cards != on one card")
        phase("sharded", "placement=2 on two distinct cards == the same "
              "mesh on one card")
    else:
        phase("sharded", "one card visible: placement=2 on distinct cards "
              "not run")
    out.update(counts=counts, fp32=fp32)
    return out


def time_sharded(torch, np, sell_core, sell_shard, pr_k, shm: dict,
                 gm: dict, flush) -> list[dict]:
    """Phase 11c's timings: B3's and B5's float forms alone at uniform21's
    shapes beside their bounds, plain versions and ``torch.sparse.mm`` in
    fp32; the SHARD_N-shard fold on one card against the unsharded call;
    each shard's X window and its padded slices.  Returns the float forms'
    records for the kernels line."""
    mesh = shm["mesh"]
    # the shard layouts: windows, boundary columns, padding
    sh, slabs = shm["sharded"], shm["big"].slabs
    phase("timing", f"big {SHARD_N} shards: rows {sh.row_counts.tolist()}, "
          f"window_cols {sh.window_cols} of {sh.n_cols} (col_starts "
          f"{sh.col_starts.tolist()}), boundary_cols {sh.boundary_cols}; "
          f"slices a shard {list(sh.slices_per_shard)} x {SHARD_N} = "
          f"{sum(sh.slices_per_shard) * SHARD_N} against the unsharded "
          f"{slabs.n_slices}; padded entries {sh.padded_nnz} against "
          f"{slabs.padded_nnz} (pad factor {sh.pad_factor:.4f} against "
          f"{slabs.pad_factor:.4f})")
    cols, vals, rows = (shm["big"].device_arrays[a] for a in
                        ("cols", "vals", "rows"))
    for k, x in shm["xs"].items():
        kb = shard_k_block(k)
        rhs = sell_core.padded_k(k, kb) >= SHARD_N * sell_core.k_tile_for(
            k, kb)
        one = time_ms(torch, lambda: sell_core.spmm_sell(
            cols, vals, rows, x, n_rows=slabs.n_rows, k_block=kb), flush)
        fold = time_ms(torch, (lambda: sell_shard.spmm_sell_rhs_sharded(
            slabs, x, mesh=mesh, k_block=kb)) if rhs else (
            lambda: sell_shard.spmm_sell_sharded(sh, x, mesh=mesh,
                                                 k_block=kb)), flush)
        phase("timing", f"big k={k}: {SHARD_N}-shard {'RHS' if rhs else 'row'}"
              f" fold on one card {fold:.4f} ms against unsharded B1 "
              f"{one:.4f} ms ({fold / one:.2f}x)")
    g = gm["graphs"]["uniform21"]
    op = gm["reg"].get("uniform21")
    adj, nodes = op.device_arrays["adj"], op.device_arrays["nodes"]
    deg = op.device_arrays["out_degree"]
    n, e = g.n_nodes, g.n_edges
    spec_sg = shm["sg_uniform21"]
    phase("timing", f"uniform21 {SHARD_N} shards: nodes "
          f"{spec_sg.node_counts.tolist()}, union widths "
          f"{list(spec_sg.widths)}, slices a shard "
          f"{list(spec_sg.slices_per_shard)} x {SHARD_N} = "
          f"{sum(spec_sg.slices_per_shard) * SHARD_N} against the unsharded "
          f"{sum(a.shape[0] for a in op.slabs.bucket_adj)}")
    lib_a = sparse_reverse(torch, np, gm["reverse_u21"]).to(torch.float32)
    records = []
    rank0 = 1.0 / n
    c1 = torch.where(deg > 0, rank0 / torch.clamp(deg, min=1), 0.0)
    dang = float(torch.where(deg == 0, rank0, 0.0).sum()) / n
    for k in (REQUESTS_PER_OPERAND, 1):
        d = torch.tensor([DAMPINGS[i % len(DAMPINGS)] for i in range(k)],
                         dtype=torch.float64, device=DEVICE)
        consts64 = torch.stack([(1.0 - d) / n, d, torch.full_like(d, dang)])
        contrib64 = torch.cat([c1, c1.new_zeros(1)])
        if k == 1:
            consts64 = consts64[:, 0].contiguous()
        else:
            contrib64 = contrib64[:, None].expand(n + 1, k).contiguous()
        # the 4-shard fold of one power step on one card against the
        # unsharded step (fp64)
        devs = sell_shard._mesh_devices(mesh, SHARD_N)
        home = devs[0]
        one = time_ms(torch, lambda: pr_k.pagerank_step_sell(
            adj, nodes, contrib64, consts64), flush)
        fold = time_ms(torch, lambda: sell_shard._graph_step(
            spec_sg, devs, home, pr_k.pagerank_step_sell, torch.add,
            (contrib64, consts64)), flush)
        phase("timing", f"uniform21 k={k}: a {SHARD_N}-shard PageRank step "
              f"fold on one card {fold:.4f} ms against the unsharded B3 step "
              f"{one:.4f} ms ({fold / one:.2f}x)")
        contrib, consts = contrib64.float(), consts64.float()

        def kernel():
            return pr_k.pagerank_step_sell(adj, nodes, contrib, consts)

        def plain():
            return pr_k.pagerank_step_sell_ref(adj, nodes, contrib, consts)

        xk = contrib[:n].reshape(n, k)

        def library():
            return torch.sparse.mm(lib_a, xk)

        got, want = kernel(), plain()
        err = fp32_check(f"uniform21 k={k}: B3 fp32 vs plain", got, want)
        cm = consts.reshape(3, k)
        fp32_check(f"uniform21 k={k}: B3 fp32 vs torch.sparse.mm",
                   got[:n].reshape(n, k), cm[0] + cm[1] * (library() + cm[2]))
        ms, plain_ms = time_ms(torch, kernel, flush), time_ms(torch, plain,
                                                              flush)
        lib_ms = time_ms(torch, library, flush)
        bytes_ms = (4 * e + 4 * n + 8 * n * k) / HBM_BYTES_PER_S * 1e3
        ops_ms = e * k / FP32_OPS * 1e3
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   max_abs_err=max_err(got.double(), want.double()),
                   rel_to_max=err)
        phase("timing", f"uniform21 k={k}: pagerank_step_sell fp32 {ms:.4f} "
              f"ms | bound {bytes_ms:.4f} ms (bytes; ops {ops_ms:.4f}) | plain"
              f" {plain_ms:.4f} ms | torch.sparse.mm fp32 {lib_ms:.4f} ms | "
              f"{err:.3e} x max|rank| from plain")
        if k == REQUESTS_PER_OPERAND:
            main = rec
        else:
            k1 = rec
    records.append({"name": "pagerank_step_sell_fp32", "route": "cuda",
                    "source": "src/repro_torch/csrc/graph_step.cu",
                    "replaces": "src/repro/kernels/pagerank.py:81",
                    "launches": shm["counts"]["pagerank_step_sell_fp32"],
                    **main, "k1": k1,
                    "shape": f"uniform21 {n} nodes {e} edges fp32, k=32, "
                             "power step 1"})
    radj, live = gm["ell_cached"]
    contrib = c1.float()
    consts = torch.tensor([(1.0 - DAMPINGS[0]) / n, DAMPINGS[0], dang],
                          dtype=torch.float32, device=DEVICE)

    def kernel():
        return pr_k.pagerank_step(radj, contrib, consts, live_width=live)

    def plain():
        return pr_k.pagerank_step_ref(radj, contrib, consts)

    def library():
        return torch.sparse.mm(lib_a, contrib[:, None])

    got, want = kernel(), plain()
    err = fp32_check("uniform21: B5 fp32 vs plain", got, want)
    fp32_check("uniform21: B5 fp32 vs torch.sparse.mm", got,
               consts[0] + consts[1] * (library()[:, 0] + consts[2]))
    ms, plain_ms = time_ms(torch, kernel, flush), time_ms(torch, plain, flush)
    lib_ms = time_ms(torch, library, flush)
    bytes_ms = (4 * e + 8 * n) / HBM_BYTES_PER_S * 1e3
    ops_ms = e / FP32_OPS * 1e3
    phase("timing", f"uniform21 k=1: pagerank_step fp32 {ms:.4f} ms | bound "
          f"{bytes_ms:.4f} ms (bytes; ops {ops_ms:.4f}) | plain {plain_ms:.4f}"
          f" ms | torch.sparse.mm fp32 {lib_ms:.4f} ms | {err:.3e} x "
          "max|rank| from plain")
    records.append({"name": "pagerank_step_fp32", "route": "cuda",
                    "source": "src/repro_torch/csrc/graph_step.cu",
                    "replaces": "src/repro/kernels/pagerank.py:33",
                    "launches": shm["counts"]["pagerank_step_fp32"],
                    "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms
                    else "operations",
                    "max_abs_err": max_err(got.double(), want.double()),
                    "rel_to_max": err,
                    "shape": f"uniform21 {n} nodes {e} edges fp32, k=1, "
                             "power step 1"})
    return records


def add_sharded(kernels: list[dict], shm: dict) -> None:
    """The sharded phase's B1 and B3 launches on the kernels line, under
    ``launches_by_path["sharded"]`` of each kernel's record."""
    for name in ("spmm_sell", "bfs_step_sell", "pagerank_step_sell"):
        rec = next(r for r in kernels if r["name"] == name)
        rec.setdefault("launches_by_path", {"main paths": rec["launches"]})
        rec["launches_by_path"]["sharded"] = shm["counts"][name]
        rec["launches"] += shm["counts"][name]


# ---------------------------------------------------------------------------
# The training path (B8 and B9, forward and backward)
# ---------------------------------------------------------------------------


def train_config(configs):
    """The train phase's model: mamba2-2.7b's published config."""
    return configs.get_config(TRAIN_ARCH)


def ssd_bwd_cases(cfg, hybrid) -> list[tuple]:
    """B8 backward compare cases (b, l, h, p, g, n, chunk, dtype): the train
    phase's (TRAIN_BATCH, TRAIN_SEQ) and (1, TRAIN_SEQ) at mamba2's widths,
    hymba's (1, TRAIN_SEQ), each in fp32 and fp64."""
    out = []
    for c, bs in ((cfg, (TRAIN_BATCH, 1)), (hybrid, (1,))):
        s = c.ssm
        out += [(b, TRAIN_SEQ, c.n_ssm_heads, s.head_dim, s.n_groups,
                 s.d_state, s.chunk, dt) for b in bs
                for dt in ("float32", "float64")]
    return out


def compare_ssd_bwd(torch, np, ssd_k, cfg, hybrid) -> float:
    """Phase 14 (B8's backward) against its plain version on the card, from
    a zero and a random initial state, with a final-state gradient and (zero
    state) without one, at SSD_TOL (fp32 relative to max(1, max|grad|));
    two calls bit-equal.  Returns the max abs error at the train step's
    shape in fp32."""
    main_err = 0.0
    for i, (b, l, h, p, g, n, q, dt) in enumerate(ssd_bwd_cases(cfg, hybrid)):
        errs = []
        for init, fin in ((False, False), (False, True), (True, True)):
            (xd, ad, B, C), s0 = ssd_inputs(torch, np, b, l, h, p, g, n, dt,
                                            seed=100 + i, init=init)
            rng = np.random.default_rng(200 + i)
            dy = torch.from_numpy(rng.standard_normal((b, l, h, p)).astype(dt)
                                  ).to(DEVICE)
            df = (torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(dt)
                                   ).to(DEVICE) if fin else None)
            before = ssd_k.BWD_LAUNCHES
            got = ssd_k.ssd_fused_bwd(xd, ad, B, C, dy, df, chunk=q,
                                      init_state=s0)
            again = ssd_k.ssd_fused_bwd(xd, ad, B, C, dy, df, chunk=q,
                                        init_state=s0)
            torch.cuda.synchronize()
            if ssd_k.BWD_LAUNCHES - before != 2 * ssd_k.LAUNCHES_PER_BWD:
                raise AssertionError("B8 backward: a call did not make its "
                                     f"{ssd_k.LAUNCHES_PER_BWD} launches")
            want = ssd_k.ssd_fused_bwd_ref(xd, ad, B, C, dy, df, chunk=q,
                                           init_state=s0)
            for name, gv, av, wv in zip(("dxd", "dad", "dB", "dC", "dinit"),
                                        got, again, want):
                if gv is None:
                    continue
                if not torch.equal(gv, av):
                    raise AssertionError(f"B8 backward {name}: two calls "
                                         "differ")
                errs.append(ssd_violation(torch, gv, wv.to(gv.dtype), dt))
        if (b, dt) == (TRAIN_BATCH, "float32") and h == cfg.n_ssm_heads:
            main_err = max(errs)
        phase("compare", f"B8 backward (b, l, h, p, g, n) = {(b, l, h, p, g, n)} "
              f"chunk {q} {dt}: max abs err {max(errs):.3e} over dxd, dad, dB, "
              "dC (and d init_state) from a zero and a random state, with and "
              "without a final-state gradient; two calls bit-equal")
    return main_err


def compare_gather_bwd(torch, np, gather_k, cfg) -> float:
    """Phase 14 (B9's backward): from mamba2's (V, d) table shape at T in
    GATHER_BWD_TS, fp32 and fp64, ids with repeats: equal to its plain
    version (the same sums in the same order), two calls bit-equal, within
    1e-6 x max of ``index_add_``.  Returns the max abs error against
    ``index_add_`` in fp32."""
    v, d = cfg.vocab_size, cfg.d_model
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        for t in GATHER_BWD_TS:
            rng = np.random.default_rng(t)
            ids_np = rng.integers(0, v, t)
            ids_np[::5] = ids_np[0]                      # a long run
            ids = torch.from_numpy(ids_np).to(DEVICE)
            dout = torch.from_numpy(rng.standard_normal((t, d))).to(
                dtype=dtype, device=DEVICE)
            before = gather_k.BWD_LAUNCHES
            got = gather_k.embedding_gather_bwd(dout, ids, v)
            again = gather_k.embedding_gather_bwd(dout, ids, v)
            torch.cuda.synchronize()
            if gather_k.BWD_LAUNCHES - before != 2:
                raise AssertionError("B9 backward: not one launch a call")
            if not (torch.equal(got, again) and torch.equal(
                    got, gather_k.embedding_gather_bwd_ref(dout, ids, v))):
                raise AssertionError(f"B9 backward T={t} {dtype}: not equal to "
                                     "its plain version")
            lib = torch.zeros((v, d), dtype=dtype, device=DEVICE
                              ).index_add_(0, ids, dout)
            err = float((got - lib).abs().max())
            if err > 1e-6 * float(lib.abs().max()):
                raise AssertionError(f"B9 backward T={t}: {err} from index_add_")
            if dtype == torch.float32:
                worst = max(worst, err)
            del got, again, lib
    phase("compare", f"B9 backward ({v}, {d}) table, T in {GATHER_BWD_TS}, fp32 "
          "and fp64, ids with repeats: equal to its plain version, two calls "
          f"bit-equal, max abs err vs index_add_ {worst:.3e} (fp32)")
    return worst


def train_counts(ssd_k, gather_k) -> dict:
    return {"ssd_fused": ssd_k.KERNEL_LAUNCHES,
            "ssd_fused_bwd": ssd_k.BWD_LAUNCHES,
            "embedding_gather": gather_k.KERNEL_LAUNCHES,
            "embedding_gather_bwd": gather_k.BWD_LAUNCHES}


def train_batch(np, cfg, b: int) -> dict:
    """Step 0 of the synthetic stream (the CLI's data) at b x TRAIN_SEQ."""
    from repro_torch.data import DataConfig, SyntheticLM

    tokens, labels = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=b,
        seed=LM_SEED)).batch_for(0)
    return {"tokens": tokens, "labels": labels}


def train_check(torch, np, M, ssd_k, gather_k, cfg) -> dict:
    """Phase 14: a 2-layer model at full width, trainable, from LM_SEED on
    the CPU and copied to the card: one train step's loss and gradients
    (:func:`repro_torch.train.step.loss_and_grads`) on the card (B8, B9
    and their backward kernels) against the CPU's (plain versions), loss
    to TRAIN_LOSS_RTOL, each gradient to TRAIN_GRAD_TOL x max|g|; then the
    card's under remat "full" against none, TRAIN_REMAT_TOL x max|g|."""
    from repro_torch.train import TrainConfig
    from repro_torch.train.step import loss_and_grads

    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS)
    cpu = M.init_params(M.make_generator(LM_SEED, "cpu"), cfg2, trainable=True)
    card = copy.deepcopy(cpu).to(DEVICE)
    batch = train_batch(np, cfg2, TRAIN_CHECK_BATCH)
    before = train_counts(ssd_k, gather_k)
    g_card, l_card, _ = loss_and_grads(card, cfg2, TrainConfig(remat=None), batch)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in train_counts(ssd_k, gather_k).items()}
    if not all(ran.values()):
        raise AssertionError(f"train check: the card's step launched {ran}")
    g_cpu, l_cpu, _ = loss_and_grads(cpu, cfg2, TrainConfig(remat=None), batch)
    rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train check: loss {float(l_card)} vs CPU "
                             f"{float(l_cpu)} ({rel:.2e} > {TRAIN_LOSS_RTOL})")
    worst, worst_name = 0.0, ""
    for k, gc in g_cpu.items():
        scale = max(float(gc.abs().max()), 1e-30)
        e = float((g_card[k].cpu() - gc).abs().max()) / scale
        if not e <= TRAIN_GRAD_TOL:
            raise AssertionError(f"train check: gradient {k} differs by {e:.2e}"
                                 f" x max|g| > {TRAIN_GRAD_TOL}")
        if e >= worst:
            worst, worst_name = e, k
    del cpu, g_cpu
    g_remat, _, _ = loss_and_grads(card, cfg2, TrainConfig(remat="full"), batch)
    rworst = max(float((g_remat[k] - g).abs().max())
                 / max(float(g.abs().max()), 1e-30) for k, g in g_card.items())
    if not rworst <= TRAIN_REMAT_TOL:
        raise AssertionError(f"train check: remat 'full' gradients differ by "
                             f"{rworst:.2e} x max|g| > {TRAIN_REMAT_TOL}")
    phase("train", f"check: {LM_CHECK_LAYERS} layers at full width, one step on "
          f"({TRAIN_CHECK_BATCH}, {TRAIN_SEQ}) tokens, card vs CPU (plain "
          f"versions): loss {float(l_card):.6f} vs {float(l_cpu):.6f} (rel "
          f"{rel:.2e} <= {TRAIN_LOSS_RTOL}); worst gradient {worst_name} "
          f"{worst:.2e} x max|g| <= {TRAIN_GRAD_TOL}; remat 'full' vs none on "
          f"the card {rworst:.2e} x max|g| <= {TRAIN_REMAT_TOL}; launches "
          f"{ran} ({time.perf_counter() - t0:.1f} s)")
    del card, g_card, g_remat
    return {"loss_rel": rel, "grad_err": worst, "remat_err": rworst}


def train_profile(torch, M, state, cfg, tcfg, batch, ssd_k, gather_k,
                  step_ms: float) -> dict:
    """One more train step of the state, under ``torch.profiler``, made of
    its parts so that the launches split: the forward (B8, B9), the
    backward (B8 recomputed under remat "full", B8's and B9's backward
    kernels), the AdamW update.  The device's busy time against the wall
    clock under the profiler (whose host-side tracing of every op
    stretches it) and against ``step_ms``, an unprofiled step's wall; B8's
    and B9's (forward and backward) shares of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.layers import softmax_cross_entropy
    from repro_torch.optim import adamw_update, decay_mask

    params = state.params
    named = dict(params.named_parameters())
    counts = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        counts.append(train_counts(ssd_k, gather_k))
        logits, aux = M.forward(params, cfg, batch, remat=tcfg.remat)
        loss, _ = softmax_cross_entropy(logits, batch["labels"])
        counts.append(train_counts(ssd_k, gather_k))
        grads = torch.autograd.grad(loss + tcfg.aux_weight * aux,
                                    list(named.values()))
        counts.append(train_counts(ssd_k, gather_k))
        adamw_update(dict(zip(named, grads)), state.opt, named, tcfg.optimizer,
                     decay=decay_mask(named))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    del grads, logits
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev) / 1e3

    def share(*keys):
        ms = sum(e.device_time_total for e in dev
                 if any(k in e.key for k in keys)) / 1e3
        return ms, (100 * ms / busy if busy > 0 else None)

    parts = {"b8_fwd": share("ssd_chunk", "ssd_state_pass"),
             "b8_bwd": share("ssd_bwd"),
             "b9_fwd": share("gather_rows_kernel"),
             "b9_bwd": share("gather_bwd_kernel")}
    split = {k: {"forward": counts[1][k] - counts[0][k],
                 "backward": counts[2][k] - counts[1][k]} for k in counts[0]}
    top = sorted(dev, key=lambda e: e.device_time_total, reverse=True)[:5]
    busy_txt = (f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}% of "
                f"it; {100 * busy / step_ms:.1f}% of an unprofiled step's "
                f"{step_ms:.1f} ms)" if busy > 0
                else "device time not measured (no device events)")
    phase("profile", f"{cfg.name} train step ({TRAIN_BATCH}, {TRAIN_SEQ}) remat "
          f"{tcfg.remat}: wall {wall_ms:.1f} ms under the profiler; {busy_txt}; "
          + "; ".join(f"{k} {ms:.2f} ms" + ("" if pct is None else f" ({pct:.1f}%)")
                      for k, (ms, pct) in parts.items())
          + "; most device time: " + "; ".join(
              f"{e.key[:40]} {e.device_time_total / 1e3:.2f} ms x{e.count}"
              for e in top))
    phase("train", "launches in that step, forward / in the backward (B8's "
          "forward kernel there is the remat recompute): " + ", ".join(
              f"{k} {v['forward']} / {v['backward']}" for k, v in split.items()))
    return {"wall_ms": wall_ms, "busy_ms": busy, "step_ms": step_ms,
            "parts": parts, "split": split}


def train_resume(torch, configs) -> float:
    """Phase 14: resume on the card at the reduced config — a run crashed at
    step 5 restarts from its step-4 checkpoint and ends where an
    uninterrupted run ends, within TRAIN_RESUME_TOL."""
    import shutil

    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, TrainLoopConfig, train_loop

    cfg = configs.reduced_config(TRAIN_ARCH)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat=None)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=2 * cfg.ssm.chunk,
                      global_batch=4, seed=LM_SEED)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)

    def lcfg(name):
        return TrainLoopConfig(total_steps=8, ckpt_every=4, log_every=100,
                               ckpt_dir=str(TRAIN_CKPT / name), seed=LM_SEED)

    quiet = lambda s: None  # noqa: E731
    whole, _ = train_loop(cfg, tcfg, dcfg, lcfg("whole"), log=quiet,
                          device=DEVICE)
    try:
        train_loop(cfg, tcfg, dcfg, lcfg("crashed"), log=quiet,
                   fail_at_step=5, device=DEVICE)
        raise AssertionError("resume: the injected failure did not happen")
    except RuntimeError as e:
        if "injected failure at step 5" not in str(e):
            raise
    logs = []
    resumed, hist = train_loop(cfg, tcfg, dcfg, lcfg("crashed"),
                               log=logs.append, device=DEVICE)
    if logs[:1] != ["[resume] restored checkpoint at step 4"] or \
            [h["step"] for h in hist] != [4, 5, 6, 7]:
        raise AssertionError(f"resume: {logs[:1]}, steps {[h['step'] for h in hist]}")
    worst = max(float((a - b).detach().abs().max()) for a, b in
                zip(whole.params.parameters(), resumed.params.parameters()))
    if not worst <= TRAIN_RESUME_TOL:
        raise AssertionError(f"resume: parameters differ by {worst} > "
                             f"{TRAIN_RESUME_TOL}")
    phase("train", f"resume on the card ({cfg.name}, {dcfg.global_batch} x "
          f"{dcfg.seq_len} tokens): crashed at step 5, restored the step-4 "
          f"checkpoint, ran steps 4-7; final parameters vs an uninterrupted "
          f"run max abs diff {worst:.3e} <= {TRAIN_RESUME_TOL}")
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    return worst


def train_path(torch, np, configs, M, ssd_k, gather_k) -> dict:
    """Phase 14, the main path: mamba2-2.7b at full width and depth trained
    TRAIN_STEPS steps through the port's CLI
    (:func:`repro_torch.launch.train.main`: random init on the card from
    LM_SEED, the synthetic stream, remat "full", AdamW at TRAIN_LR), the
    four counts set to 0 just before and read just after; each step's
    loss, grad norm and ms, tokens/s, the peak device memory; then one
    more step profiled (:func:`train_profile`)."""
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig

    t0 = time.perf_counter()
    cfg = train_config(configs)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    phase("train", f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}; device memory before init {free / 1e9:.2f} "
          f"GB free of {total / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", TRAIN_ARCH, "--seq-len", str(TRAIN_SEQ), "--batch",
            str(TRAIN_BATCH), "--remat", TRAIN_REMAT, "--steps",
            str(TRAIN_STEPS), "--lr", str(TRAIN_LR), "--seed", str(LM_SEED),
            "--device", DEVICE]
    if cfg == configs.get_config(TRAIN_ARCH):
        argv.append("--full")
    ssd_k.KERNEL_LAUNCHES = ssd_k.BWD_LAUNCHES = 0
    gather_k.KERNEL_LAUNCHES = gather_k.BWD_LAUNCHES = 0
    state, hist = train_cli.main(argv, log=lambda s: print(s, flush=True))
    torch.cuda.synchronize()
    launches = train_counts(ssd_k, gather_k)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in state.params.parameters())
    for h in hist:
        phase("train", f"step {h['step']}: loss {h['loss']:.6f} grad norm "
              f"{h['grad_norm']:.6f} lr {h['lr']:.3e} {h['wall_s'] * 1e3:.1f} ms")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist):
        raise AssertionError(f"train: a loss or grad norm is not finite: {hist}")
    if not all(launches.values()):
        raise AssertionError(f"train: the run launched {launches}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = [h["wall_s"] for h in hist[1:]] or [hist[0]["wall_s"]]
    tps = tokens / statistics.median(steady)
    phase("train", f"{cfg.name} ({n_params / 1e9:.3f} B parameters, fp32) "
          f"{len(hist)} steps of ({TRAIN_BATCH}, {TRAIN_SEQ}) tokens, remat "
          f"{TRAIN_REMAT}: {tps:.1f} tokens/s (median of steps 1+; step 0 "
          f"{hist[0]['wall_s'] * 1e3:.1f} ms); peak device memory {peak:.2f} "
          f"GB; launches {launches}")
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR), remat=TRAIN_REMAT)
    prof = train_profile(torch, M, state, cfg, tcfg,
                         {k: torch.as_tensor(v).to(DEVICE) if k == "labels" else v
                          for k, v in train_batch(np, cfg, TRAIN_BATCH).items()},
                         ssd_k, gather_k, statistics.median(steady) * 1e3)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    phase("train", f"main path done in {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "hist": hist, "tokens_per_s": tps,
            "peak_gb": peak, "profile": prof, "cfg": cfg}


def time_train_kernels(torch, np, ssd_k, gather_k, tm: dict, errs: dict,
                       flush) -> list[dict]:
    """Phase 14 (timing): B8's backward at the train step's scan shape and
    B9's at its ids (CUDA events, the L2 flushed) beside their bounds, the
    plain versions and, for B9, ``zeros + index_add_``."""
    from repro_torch.core import autotune

    cfg = tm["cfg"]
    s = cfg.ssm
    b, l, h, p, g, n, q = (TRAIN_BATCH, TRAIN_SEQ, cfg.n_ssm_heads, s.head_dim,
                           s.n_groups, s.d_state, s.chunk)
    (xd, ad, B, C), _ = ssd_inputs(torch, np, b, l, h, p, g, n, "float32", seed=12)
    dy = torch.randn_like(xd)
    _, fstate, cum, entering = ssd_k._forward(xd, ad, B, C, q, None, keep=True)
    saved = (fstate, cum, entering)
    ms = time_ms(torch, lambda: ssd_k.ssd_fused_bwd(xd, ad, B, C, dy, chunk=q,
                                                     saved=saved), flush)
    plain_ms = time_ms(torch, lambda: ssd_k.ssd_fused_bwd_ref(xd, ad, B, C, dy,
                                                              chunk=q), flush)
    # each launch alone through its C entry point, in order once first
    from repro_torch.kernels import cuda_lib

    buf = ssd_k._BwdBuffers(xd, B, None, q)
    calls = ssd_k._bwd_calls(cuda_lib.library("ssd_bwd"), xd, B, C, dy, None, None,
                             fstate, cum, entering, q, buf,
                             torch.cuda.current_stream().cuda_stream)
    for name in autotune.SSD_BWD_LAUNCHES:
        if calls[name]():
            raise AssertionError(f"B8 backward {name} was refused")
    launch_ms = {name: time_ms(torch, calls[name], flush)
                 for name in autotune.SSD_BWD_LAUNCHES}
    del buf, calls
    nc = l // q
    nbytes = 4 * (3 * b * l * h * p + 2 * b * l * h + 4 * b * l * g * n
                  + b * h * l + b * h * nc * p * n + b * h * p * n)
    flops = autotune.ssd_bwd_flops(b, l, h, p, n, q)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_OPS * 1e3
    tf32_ms = 3 * flops / TF32_OPS * 1e3
    phase("timing", f"B8 backward (b, l, h, p, g, n) = {(b, l, h, p, g, n)} chunk "
          f"{q} fp32: {ms:.4f} ms in {ssd_k.LAUNCHES_PER_BWD} launches ("
          + ", ".join(f"{k} {v:.4f}" for k, v in launch_ms.items())
          + f" alone) | bound {max(ops_ms, bytes_ms):.4f} ms (ops {ops_ms:.4f}: "
          f"{flops / 1e9:.3f} GFLOP at the CUDA cores' 67 TFLOP/s; bytes "
          f"{bytes_ms:.4f}); 3xTF32 floor {tf32_ms:.4f} ms (3 x the GFLOP at the "
          f"tensor cores' 495 TFLOP/s) | plain {plain_ms:.4f} ms | no single "
          f"PyTorch call | {flops / ms / 1e6:.1f} GFLOP/s of the function")
    ssd_rec = {"name": "ssd_fused_bwd", "route": "cuda",
               "source": "src/repro_torch/csrc/ssd_bwd.cu",
               "replaces": "src/repro/kernels/ssd.py:78 (its backward: the "
                           "reference differentiates src/repro/models/ssm.py:81)",
               "launches": tm["launches"]["ssd_fused_bwd"],
               "max_abs_err": errs["ssd"], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "library_ms": None, "launch_ms": launch_ms,
               "shape": f"(b, l, h, p, g, n) = {(b, l, h, p, g, n)} chunk {q} "
                        "fp32 (a train step's layer)"}
    del xd, ad, B, C, dy, saved, fstate, cum, entering

    v, d = cfg.vocab_size, cfg.d_model
    t = TRAIN_BATCH * TRAIN_SEQ
    ids = torch.from_numpy(train_batch(np, cfg, TRAIN_BATCH)["tokens"].reshape(-1)
                           .astype(np.int64)).to(DEVICE)
    dout = torch.randn((t, d), dtype=torch.float32, device=DEVICE)
    gms = time_ms(torch, lambda: gather_k.embedding_gather_bwd(dout, ids, v), flush)
    gplain = time_ms(torch, lambda: gather_k.embedding_gather_bwd_ref(dout, ids, v),
                     flush)
    glib = time_ms(torch, lambda: torch.zeros((v, d), device=DEVICE)
                   .index_add_(0, ids, dout), flush)
    # the launch alone, on the wrapper's plan and buffers (the wrapper adds
    # its host work: the plan lookup and the output's allocation)
    plan, (stripe, chunks, threads, vec) = gather_k._bwd_plan(
        v, d, t, torch.float32, ids.dtype)
    dtable = torch.empty((v, d), dtype=torch.float32, device=DEVICE)
    glaunch = time_ms(torch, lambda: gather_k._launch_bwd(
        ids, dout, dtable, vec, stripe, chunks, threads), flush)
    gbound = ((v * d + t * d) * 4 + 8 * t) / HBM_BYTES_PER_S * 1e3
    blk = plan.blocks[0]
    phase("timing", f"B9 backward T={t} into ({v}, {d}) fp32 (the train step's "
          f"ids, no sort: one launch), grid {blk.grid} x {blk.block[0]} "
          f"(stripes of {stripe} rows, {vec} B vectors): wrapper {gms:.4f} ms | "
          f"launch alone {glaunch:.4f} ms | bound {gbound:.4f} ms (bytes) | "
          f"plain {gplain:.4f} ms | zeros + index_add_ {glib:.4f} ms")
    del dtable
    gather_rec = {"name": "embedding_gather_bwd", "route": "cuda",
                  "source": "src/repro_torch/csrc/embedding_gather.cu",
                  "replaces": "src/repro/kernels/gather.py:44 (its backward: "
                              "the reference differentiates XLA's gather, "
                              "src/repro/models/model.py:118)",
                  "launches": tm["launches"]["embedding_gather_bwd"],
                  "max_abs_err": errs["gather"], "ms": gms, "plain_ms": gplain,
                  "bound_ms": gbound, "bound_by": "bytes", "library_ms": glib,
                  "launch_ms": glaunch,
                  "shape": f"T={t} ids into ({v}, {d}) fp32 (a train step's "
                           "tokens)"}
    return [ssd_rec, gather_rec]


def add_train(kernels: list[dict], tm: dict) -> None:
    """The train phase's forward launches of B8 and B9 on their kernels
    line records, under ``launches_by_path["train"]``."""
    for name in ("ssd_fused", "embedding_gather"):
        rec = next(r for r in kernels if r["name"] == name)
        rec.setdefault("launches_by_path", {"lm": rec["launches"]})
        rec["launches_by_path"]["train"] = tm["launches"][name]
        rec["launches"] += tm["launches"][name]


# ---------------------------------------------------------------------------
# The mesh phase: the dense and MoE families on a (data, model) mesh
# ---------------------------------------------------------------------------


def mesh_config(configs, arch: str, layers):
    """A mesh run's model: ``arch``'s published config, cut to ``layers``
    (deepseek's 2: its dense first layer and one MoE layer)."""
    cfg = configs.get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def gather_shard_ids(torch, np, v: int, n_shards: int, t: int, id_dtype, seed):
    """(t,) ids on the card: every shard's first and last rows and ids past
    either end of the vocabulary (a card's ids, bounded by the kernel),
    then random rows."""
    rows = v // n_shards
    edge = [e for k in range(n_shards) for e in (k * rows, (k + 1) * rows - 1)]
    edge += [v, v + 7, -1, -v - 3, 2**31 - 1, -v]
    ids = np.random.default_rng(seed).integers(0, v, t)
    ids[:min(t, len(edge))] = edge[:t]
    return torch.tensor(ids, dtype=id_dtype, device=DEVICE)


def compare_gather_shard(torch, np, gather_k) -> float:
    """B9's vocab-shard form against its plain version on the card, each
    of MESH_GATHER_SHARDS row shards of mixtral's and llama's tables, T =
    LM_PROMPT and LM_SLOTS, int32 and int64 ids (every shard's boundary
    rows, card ids past V and below 0): ``torch.equal``, one launch a
    call, the shards' sum equal to the whole-table gather.  Returns the
    largest absolute difference seen (0 where every case is equal)."""
    n_cases, worst = 0, 0.0
    for name, (v, d) in MESH_GATHER_TABLES.items():
        table = torch.randn((v, d), dtype=torch.float32, device=DEVICE)
        rows = v // MESH_GATHER_SHARDS
        for t in (LM_PROMPT, LM_SLOTS):
            for id_dtype in (torch.int32, torch.int64):
                ids = gather_shard_ids(torch, np, v, MESH_GATHER_SHARDS, t,
                                       id_dtype, t)
                total = None
                for k in range(MESH_GATHER_SHARDS):
                    shard = table[k * rows:(k + 1) * rows]
                    before = gather_k.SHARD_LAUNCHES
                    got = gather_k.embedding_gather_shard(shard, ids, k * rows, v)
                    torch.cuda.synchronize()
                    if gather_k.SHARD_LAUNCHES != before + 1:
                        raise AssertionError("B9 shard: not one launch a call")
                    want = gather_k.embedding_gather_shard_ref(shard, ids,
                                                               k * rows, v)
                    worst = max(worst, max_err(got, want))
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"B9 shard {name} k={k} T={t} {id_dtype}: max err "
                            f"{max_err(got, want):.3e}")
                    total = got if total is None else total + got
                    n_cases += 1
                if not torch.equal(total, gather_k.embedding_gather_ref(table, ids)):
                    raise AssertionError(f"B9 shard {name} T={t}: the shards "
                                         "do not sum to the whole gather")
        del table
    phase("compare", f"B9 shard form: {n_cases} cases torch.equal to "
          f"embedding_gather_shard_ref ({MESH_GATHER_SHARDS} row shards of "
          f"{', '.join(f'{n} {v}x{d}' for n, (v, d) in MESH_GATHER_TABLES.items())}"
          f", T in ({LM_PROMPT}, {LM_SLOTS}), int32 / int64 ids with every "
          "boundary row and card ids outside [0, V)); the shards sum to the "
          "whole-table gather")
    return worst


def time_gather_shard(torch, np, gather_k, flush, launches: int,
                      err: float) -> dict:
    """B9's shard form at the mesh runs' shapes: mixtral's and llama's
    (V / 4, d) shard (shard 1) at T = LM_PROMPT and LM_SLOTS, int64 ids
    across the whole vocabulary on the card, the median of 10 CUDA-event
    timings with the L2 flushed, beside the whole-table B9 at the same T
    and the plain version.  Bound: bytes this run's ids need (the T output
    rows written, the rows this shard owns read once each, the ids read)
    over HBM_BYTES_PER_S."""
    out = {}
    for name, (v, d) in MESH_GATHER_TABLES.items():
        table = torch.randn((v, d), dtype=torch.float32, device=DEVICE)
        rows = v // MESH_GATHER_SHARDS
        shard = table[rows:2 * rows]
        for t in (LM_PROMPT, LM_SLOTS):
            ids = torch.tensor(np.random.default_rng(t).integers(0, v, t),
                               dtype=torch.int64, device=DEVICE)
            owned = int(((ids >= rows) & (ids < 2 * rows)).sum())
            ms = time_ms(torch, lambda: gather_k.embedding_gather_shard(
                shard, ids, rows, v), flush)
            whole_ms = time_ms(torch, lambda: gather_k.embedding_gather(
                table, ids), flush)
            plain_ms = time_ms(torch, lambda: gather_k.embedding_gather_shard_ref(
                shard, ids, rows, v), flush)
            nbytes = (t + owned) * d * 4 + t * 8
            rec = {"ms": ms, "whole_table_ms": whole_ms, "plain_ms": plain_ms,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "owned_rows": owned}
            out[(name, t)] = rec
            phase("timing", f"B9 shard {name} ({rows}, {d}) shard 1, T={t}: "
                  f"{ms:.4f} ms | whole-table B9 {whole_ms:.4f} ms | plain "
                  f"{plain_ms:.4f} ms | bound {rec['bound_ms']:.4f} ms "
                  f"({owned} rows owned) | {smi_line()}")
        del table, shard
    main = out[("mixtral-8x7b", LM_PROMPT)]
    return {"name": "embedding_gather_shard", "route": "cuda",
            "source": "src/repro_torch/csrc/embedding_gather.cu",
            "replaces": "src/repro/kernels/gather.py:24",
            "launches": launches, "max_abs_err": err,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "whole_table_ms": main["whole_table_ms"],
            "shape": f"T={LM_PROMPT} int64 ids on the card, shard 1 of "
                     f"mixtral's table over a {MESH_GATHER_SHARDS}-way model "
                     "axis (8000, 4096) fp32",
            "other": {f"{n} T={t}": r for (n, t), r in out.items()
                      if (n, t) != ("mixtral-8x7b", LM_PROMPT)}}


def greedy_steps(torch, np, M, params, cfg, prompts, n_steps: int, *,
                 mesh=None, scope=contextlib.nullcontext, ctx=None,
                 keep_prefill: bool = False):
    """Prefill ``prompts`` (with ``ctx`` as ``ctx_embeds`` where given) and
    ``n_steps - 1`` greedy decode steps: each step's last logits (on the
    host; with ``keep_prefill`` the whole prefill logits too), the greedy
    tokens, their top-2 margins and the host-clock ms of the prefill and a
    decode step (the card synchronized)."""
    batch = {"tokens": prompts}
    if ctx is not None:
        batch["ctx_embeds"] = ctx
    with scope():
        caches = M.init_caches(cfg, prompts.shape[0], LM_PROMPT + LM_NEW_TOKENS,
                               dtype=torch.float32, device=DEVICE, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = M.prefill(params, cfg, batch, caches, mesh=mesh)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        pre = logits.cpu() if keep_prefill else None
        last = logits[:, -1]
        del logits
        steps = [last.cpu()]
        t0 = time.perf_counter()
        for _ in range(n_steps - 1):
            last, caches = M.decode_step(params, cfg,
                                         torch.argmax(last, dim=-1)[:, None],
                                         caches, mesh=mesh)
            steps.append(last.cpu())
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / max(n_steps - 1, 1)
    last = torch.stack(steps, 1).numpy()
    top2 = np.sort(last, axis=-1)[..., -2:]
    return {"steps": last, "tokens": last.argmax(-1).astype(np.int32),
            "margins": top2[..., 1] - top2[..., 0], "prefill": pre,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def mesh_prefill(torch, M, params, cfg, prompts, mesh=None,
                 scope=contextlib.nullcontext):
    """The (b, S) prefill logits on the host (the logits check's)."""
    with scope():
        caches = M.init_caches(cfg, prompts.shape[0], LM_PROMPT + LM_NEW_TOKENS,
                               dtype=torch.float32, device=DEVICE, mesh=mesh)
        logits, _ = M.prefill(params, cfg, {"tokens": prompts}, caches,
                              mesh=mesh)
    return logits.cpu()


def serve_batcher(torch, serve, cfg, params, prompts, mesh=None) -> tuple:
    """LM_REQUESTS requests of LM_PROMPT tokens and LM_NEW_TOKENS new ones
    through ``Batcher(n_slots=LM_SLOTS)``: tokens by request and tokens/s."""
    gcfg = serve.GenerationConfig(cache_len=LM_PROMPT + LM_NEW_TOKENS)
    b = serve.Batcher(cfg, params, n_slots=LM_SLOTS, gcfg=gcfg, mesh=mesh)
    for rid, pr in enumerate(prompts):
        b.submit(serve.Request(rid=rid, prompt=pr, max_new_tokens=LM_NEW_TOKENS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = b.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = {r.rid: r.generated for r in done}
    return toks, sum(len(t) for t in toks.values()) / wall


def mesh_path(torch, np, configs, M, serve, moe, sell_core, gather_k,
              KernelRegistry, KernelService, make_mesh, sharding) -> dict:
    """Phase 15: the dense and MoE families tensor-, expert- and
    data-parallel over (data, model) meshes naming the card data x model
    times (one process drives every device of a mesh; here all are
    cuda:0).  For each of MESH_RUNS: the model at full width from LM_SEED
    on the card, unsharded; its greedy continuation of LM_REQUESTS prompts
    (LM_PROMPT tokens, LM_NEW_TOKENS new) with top-2 margins and its
    batcher's tokens; then on each mesh the same weights placed by the
    partition rules: prefill logits of (LM_SLOTS, LM_PROMPT) prompts and
    MESH_DECODE_STEPS decode steps within MESH_LOGIT_RTOL x max|logit| of
    the unsharded run (the MoE combines on B1, ``moe.sell_dispatch``),
    greedy tokens equal past the margin, and the batcher's tokens; on
    mixtral's first mesh the plain and the fused engine (its combines on B1
    through a service whose registry is on the lead device).  Each mesh's
    drive runs with B9's and B1's counts set to 0 just before it and read
    just after: the shard form of B9 must have launched, and B1 for a MoE
    model."""
    out = {"b9_shard": 0, "b1": 0, "runs": []}
    for arch, layers, shapes in MESH_RUNS:
        t_arch = time.perf_counter()
        cfg = mesh_config(configs, arch, layers)
        gc.collect()
        torch.cuda.empty_cache()
        params = M.init_params(M.make_generator(LM_SEED, DEVICE), cfg)
        rng = np.random.default_rng(LM_SEED)
        prompts = rng.integers(0, cfg.vocab_size,
                               (LM_REQUESTS, LM_PROMPT)).astype(np.int32)
        head = prompts[:LM_SLOTS]
        want = greedy_steps(torch, np, M, params, cfg, prompts, LM_NEW_TOKENS)
        want_pre = mesh_prefill(torch, M, params, cfg, head)
        is_moe = cfg.moe is not None
        scope = moe.sell_dispatch if is_moe else contextlib.nullcontext
        # the unsharded times at the mesh runs' batch and dispatch, after the
        # same warm call
        base = greedy_steps(torch, np, M, params, cfg, head,
                            MESH_DECODE_STEPS + 1, scope=scope)
        scale = float(np.abs(want["steps"]).max())
        tol = MESH_LOGIT_RTOL * max(1.0, float(want_pre.abs().max()), scale)
        plain_toks, plain_tps = serve_batcher(torch, serve, cfg, params, prompts)
        for rid, toks in plain_toks.items():
            margin_rule(np.asarray([toks]), want["tokens"][rid:rid + 1],
                        want["margins"][rid:rid + 1], tol, label=f"mesh {arch}")
        phase("mesh", f"{cfg.name}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {describe_lm(cfg)}, vocab {cfg.vocab_size}; "
              f"unsharded: prefill ({LM_SLOTS}, {LM_PROMPT}) "
              f"{base['prefill_ms']:.2f} ms, decode {base['decode_ms']:.2f} ms "
              f"a step of {LM_SLOTS}, batcher {plain_tps:.2f} tokens/s")
        for k, shape in enumerate(shapes):
            n_dev = shape[0] * shape[1]
            mesh = make_mesh(shape, ("data", "model"), (MESH_DEVICE,) * n_dev)
            t0 = time.perf_counter()
            placed = sharding.place_params(params, cfg, mesh)
            torch.cuda.synchronize()
            place_s = time.perf_counter() - t0
            gather_k.SHARD_LAUNCHES = 0
            sell_core.KERNEL_LAUNCHES = 0
            got_pre = mesh_prefill(torch, M, placed, cfg, head, mesh, scope)
            got = greedy_steps(torch, np, M, placed, cfg, head,
                               MESH_DECODE_STEPS + 1, mesh=mesh, scope=scope)
            pre_err = max_err(got_pre, want_pre)
            step_err = float(np.abs(got["steps"] - want["steps"][
                :LM_SLOTS, :MESH_DECODE_STEPS + 1]).max())
            if pre_err > tol or step_err > tol:
                raise AssertionError(
                    f"mesh {arch} {shape}: logits differ by {pre_err:.3e} "
                    f"(prefill) / {step_err:.3e} (decode) > {tol:.3e}")
            checked, close = margin_rule(
                got["tokens"], want["tokens"][:LM_SLOTS, :MESH_DECODE_STEPS + 1],
                want["margins"][:LM_SLOTS], tol, label=f"mesh {arch} {shape}")
            toks, tps = serve_batcher(torch, serve, cfg, placed, prompts, mesh)
            for rid, t in toks.items():
                margin_rule(np.asarray([t]), want["tokens"][rid:rid + 1],
                            want["margins"][rid:rid + 1], tol,
                            label=f"mesh {arch} {shape} batcher {rid}")
            same = sum(toks[r] == plain_toks[r] for r in toks)
            run = {"arch": arch, "layers": cfg.n_layers, "mesh": list(shape),
                   "prefill_ms": got["prefill_ms"], "decode_ms": got["decode_ms"],
                   "unsharded_prefill_ms": base["prefill_ms"],
                   "unsharded_decode_ms": base["decode_ms"],
                   "tokens_per_s": tps, "unsharded_tokens_per_s": plain_tps,
                   "prefill_err": pre_err, "decode_err": step_err,
                   "place_s": place_s}
            if is_moe and k == 0 and arch == MESH_RUNS[0][0]:
                run.update(mesh_engines(torch, np, serve, moe, KernelRegistry,
                                        KernelService, cfg, placed, mesh, head,
                                        want, tol))
            b9, b1 = gather_k.SHARD_LAUNCHES, sell_core.KERNEL_LAUNCHES
            if b9 == 0:
                raise AssertionError(f"mesh {arch} {shape}: no B9 shard launch")
            if is_moe and b1 == 0:
                raise AssertionError(f"mesh {arch} {shape}: no B1 launch on "
                                     "the MoE combines")
            run.update(b9_shard_launches=b9, b1_launches=b1)
            out["b9_shard"] += b9
            out["b1"] += b1
            out["runs"].append(run)
            phase("mesh", f"{cfg.name} on {shape} (data, model) over {MESH_DEVICE} x "
                  f"{n_dev}: placed in {place_s:.2f} s; prefill ({LM_SLOTS}, "
                  f"{LM_PROMPT}) {got['prefill_ms']:.2f} ms, decode "
                  f"{got['decode_ms']:.2f} ms a step of {LM_SLOTS}, batcher "
                  f"{tps:.2f} tokens/s (unsharded {plain_tps:.2f}); logits "
                  f"within {pre_err:.3e} / {step_err:.3e} of the unsharded "
                  f"(limit {tol:.3e}); {len(checked)} greedy tokens equal, "
                  f"{len(close)} within the margin; batcher {same} of "
                  f"{len(toks)} requests equal to the unsharded batcher's, all "
                  f"past the margin; B9 shard launches {b9}, B1 {b1} | "
                  f"{smi_line()}")
            del placed
            gc.collect()
            torch.cuda.empty_cache()
        del params
        phase("mesh", f"{cfg.name} done in {time.perf_counter() - t_arch:.1f} s")
    return out


def mesh_engines(torch, np, serve, moe, KernelRegistry, KernelService, cfg,
                 placed, mesh, prompts, want, tol) -> dict:
    """The plain and the fused engine on a mesh, LM_NEW_TOKENS tokens of
    ``prompts``: the fused run's combines are ``moe_dispatch`` requests of
    a float32 envelope on a service whose registry is on the lead device
    (kernel B1); its tokens equal the plain engine's past the margin."""
    m = cfg.moe
    replicas = mesh.shape["data"]
    b, s = prompts.shape
    cap = int(s * m.top_k / m.n_experts * m.capacity_factor) + 1
    reg = KernelRegistry(device=DEVICE)
    reg.register_moe("mesh-moe", n_tokens=b * s // replicas,
                     n_slots=b // replicas * m.n_experts * cap,
                     d_model=cfg.d_model, top_k=m.top_k, dtype="float32")
    svc = KernelService(reg, n_slots=LM_SLOTS)
    gcfg = serve.GenerationConfig(max_new_tokens=LM_NEW_TOKENS,
                                  cache_len=LM_PROMPT + LM_NEW_TOKENS)
    ran = {}
    for name, kw in (("plain", {}), ("fused", dict(kernel_service=svc,
                                                   moe_operand="mesh-moe"))):
        eng = serve.ServeEngine(cfg, placed, gcfg, mesh=mesh, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ran[name] = eng.generate(prompts)
        torch.cuda.synchronize()
        ran[name + "_tokens_per_s"] = ran[name].size / (time.perf_counter() - t0)
    margin_rule(ran["plain"], want["tokens"][:b], want["margins"][:b], tol,
                label="mesh plain engine")
    margin_rule(ran["fused"], ran["plain"], want["margins"][:b], tol,
                label="mesh fused engine")
    n = svc.stats["moe_dispatch_launches"]
    phase("mesh", f"{cfg.name} engines on {tuple(mesh.devices.shape)}: plain "
          f"{ran['plain_tokens_per_s']:.2f} tokens/s, fused "
          f"{ran['fused_tokens_per_s']:.2f} tokens/s ({n} moe_dispatch "
          f"launches on B1 through the service on {reg.device}); fused tokens "
          f"{'equal to' if np.array_equal(ran['fused'], ran['plain']) else 'past the margin of'}"
          " the plain engine's")
    return {"plain_engine_tokens_per_s": ran["plain_tokens_per_s"],
            "fused_engine_tokens_per_s": ran["fused_tokens_per_s"],
            "fused_moe_dispatch_launches": n}


def add_mesh(kernels: list[dict], mp: dict, shard_rec: dict) -> None:
    """The mesh phase on the kernels line: B9's shard form (its launches
    the phase's), and B1's launches there under ``launches_by_path``."""
    kernels.append(shard_rec)
    rec = next(r for r in kernels if r["name"] == "spmm_sell")
    rec.setdefault("launches_by_path", {"main paths": rec["launches"]})
    rec["launches_by_path"]["mesh"] = mp["b1"]
    rec["launches"] += mp["b1"]


# ---------------------------------------------------------------------------
# The mesh-train phase: training over a (data, model) mesh, the SSM family
# on a mesh
# ---------------------------------------------------------------------------


def mesh_train_counts(ssd_k, gather_k) -> dict:
    return {"ssd_fused": ssd_k.KERNEL_LAUNCHES,
            "ssd_fused_bwd": ssd_k.BWD_LAUNCHES,
            "embedding_gather_shard": gather_k.SHARD_LAUNCHES,
            "embedding_gather_shard_bwd": gather_k.SHARD_BWD_LAUNCHES}


def all_lm_counts(ssd_k, gather_k) -> dict:
    """:func:`mesh_train_counts` and the whole-table B9's forward and
    backward launches (a vocabulary the model axis does not divide)."""
    return dict(mesh_train_counts(ssd_k, gather_k),
                embedding_gather=gather_k.KERNEL_LAUNCHES,
                embedding_gather_bwd=gather_k.BWD_LAUNCHES)


def compare_gather_shard_bwd(torch, np, gather_k, cfg) -> float:
    """Phase 16: B9's shard backward against its plain version on each of
    MESH_GATHER_SHARDS row shards of ``cfg``'s table (mamba2: (12570,
    2560)), T in SHARD_BWD_TS, int32 and int64 ids (every shard's boundary
    rows, card ids past V and below 0, repeats): ``torch.equal``, one
    launch a call, and the shards' gradients stacked in model order
    ``torch.equal`` to the whole-table backward.  Returns the largest
    absolute difference (0 where every case is equal)."""
    v, d, n = cfg.vocab_size, cfg.d_model, MESH_GATHER_SHARDS
    rows = v // n
    worst, n_cases = 0.0, 0
    for t in SHARD_BWD_TS:
        for id_dtype in (torch.int32, torch.int64):
            ids = gather_shard_ids(torch, np, v, n, t, id_dtype, t + 1)
            dout = torch.randn((t, d), dtype=torch.float32, device=DEVICE)
            parts = []
            for k in range(n):
                before = gather_k.SHARD_BWD_LAUNCHES
                got = gather_k.embedding_gather_shard_bwd(dout, ids, k * rows,
                                                          rows, v)
                torch.cuda.synchronize()
                if gather_k.SHARD_BWD_LAUNCHES != before + 1:
                    raise AssertionError("B9 shard backward: not one launch a "
                                         "call")
                want = gather_k.embedding_gather_shard_bwd_ref(dout, ids,
                                                               k * rows, rows, v)
                worst = max(worst, max_err(got, want))
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"B9 shard backward k={k} T={t} {id_dtype}: max err "
                        f"{max_err(got, want):.3e}")
                parts.append(got)
                n_cases += 1
            if not torch.equal(torch.cat(parts),
                               gather_k.embedding_gather_bwd(dout, ids, v)):
                raise AssertionError(f"B9 shard backward T={t}: the shards do "
                                     "not stack to the whole-table backward")
            del parts
    phase("compare", f"B9 shard backward: {n_cases} cases torch.equal to "
          f"embedding_gather_shard_bwd_ref ({n} row shards of {cfg.name}'s "
          f"({v}, {d}) table, T in {SHARD_BWD_TS}, int32 / int64 ids with "
          "every boundary row, repeats and card ids outside [0, V)); the "
          "shards stack to the whole-table backward, torch.equal")
    return worst


def mesh_train_batch(np, cfg) -> dict:
    return train_batch(np, cfg, TRAIN_BATCH)


def mesh_train_check(torch, np, configs, M, sharding, make_mesh, ssd_k,
                     gather_k) -> list[dict]:
    """Phase 16: for each of MESH_TRAIN_CHECKS a 2-layer full-width cut
    (deepseek's 2: its dense first layer and one MoE layer), trainable
    from LM_SEED on the card, one step on each mesh (naming the card data
    x model times) against the unsharded port on the card, both on the
    synthetic stream's (TRAIN_BATCH, TRAIN_SEQ) tokens
    (:func:`mesh_step_check`)."""
    out = []
    for arch, shapes in MESH_TRAIN_CHECKS:
        out += mesh_step_check(torch, np, M, sharding, make_mesh, ssd_k,
                               gather_k, mesh_config(configs, arch,
                                                     LM_CHECK_LAYERS),
                               shapes, arch=arch)
    return out


def mesh_step_check(torch, np, M, sharding, make_mesh, ssd_k, gather_k, cfg,
                    shapes, *, arch: str, label: str = "mesh-train",
                    ctx=None, step: bool = True) -> list[dict]:
    """``cfg`` trainable from LM_SEED on the card, one step on each of
    ``shapes`` (meshes naming the card data x model times) against the
    unsharded port on the card, both on the synthetic stream's
    (TRAIN_BATCH, TRAIN_SEQ) tokens (and ``ctx`` as ``ctx_embeds``): the
    loss to MESH_TRAIN_LOSS_RTOL, every gradient to MESH_TRAIN_GRAD_TOL x
    max|g| and their global norm to MESH_TRAIN_NORM_RTOL; with ``step``
    also the grad norm of a whole train step, the parameters AdamW makes on
    the mesh (ZeRO-1 blocks) of the unsharded gradients to
    MESH_TRAIN_PARAM_TOL x max|p| of the unsharded update, and every
    block's pieces ``torch.equal`` after the step.  (A whole step's
    parameters are printed, not held: AdamW's first step is g / (|g| +
    eps), so an element whose tiny g the rounding turns moves by 2 lr.)"""
    from repro_torch.optim import adamw_init, adamw_update, decay_mask
    from repro_torch.optim import global_norm
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.step import loss_and_grads

    out = []
    tc = TrainConfig(remat=None)
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    lm = M.init_params(M.make_generator(LM_SEED, DEVICE), cfg, trainable=True)
    batch = mesh_train_batch(np, cfg)
    if ctx is not None:
        batch["ctx_embeds"] = ctx
    g1, l1, _ = loss_and_grads(lm, cfg, tc, batch)
    norm1 = float(global_norm(g1))
    p1 = None
    if step:
        p1 = {k: p.detach().clone() for k, p in lm.named_parameters()}
        adamw_update(g1, adamw_init(p1), p1, tc.optimizer, decay=decay_mask(p1))
    for shape in shapes:
        mesh = make_mesh(shape, ("data", "model"),
                         (MESH_DEVICE,) * (shape[0] * shape[1]))
        placed = sharding.place_params(lm, cfg, mesh)
        before = all_lm_counts(ssd_k, gather_k)
        g2, l2, _ = loss_and_grads(placed, cfg, tc, batch)
        torch.cuda.synchronize()
        ran = {k: v - before[k] for k, v in
               all_lm_counts(ssd_k, gather_k).items()}
        loss_rel = abs(float(l2) - float(l1)) / abs(float(l1))
        if not loss_rel <= MESH_TRAIN_LOSS_RTOL:
            raise AssertionError(f"{label} {arch} {shape}: loss "
                                 f"{float(l2)} vs {float(l1)}")
        grad_err, worst_name = 0.0, ""
        for k, g in g1.items():
            e = float((g2[k].full() - g).abs().max()) / max(
                float(g.abs().max()), 1e-30)
            if not e <= MESH_TRAIN_GRAD_TOL:
                raise AssertionError(f"{label} {arch} {shape}: gradient "
                                     f"{k} differs by {e:.2e} x max|g|")
            if e >= grad_err:
                grad_err, worst_name = e, k
        norm_rel = abs(float(global_norm(g2)) - norm1) / norm1
        del g2
        rec = {"arch": arch, "mesh": list(shape), "layers": cfg.n_layers,
               "loss_rel": loss_rel, "grad_err": grad_err,
               "norm_rel": norm_rel, "launches": ran}
        if step:
            state = init_train_state(None, cfg, tc, params=placed)
            state, m = make_train_step(cfg, tc)(state, batch)
            norm_rel = max(norm_rel, abs(float(m["grad_norm"]) - norm1) / norm1)
            step_diff = max(float((leaf.full() - p1[k]).detach().abs().max())
                            for k, leaf in state.params.items())
            for k, leaf in list(state.params.items()) + [
                    (k, x) for k, x in state.opt["m"].items()]:
                for grp in sharding.groups(leaf):
                    if not all(torch.equal(leaf.pieces[c], leaf.pieces[grp[0]])
                               for c in grp):
                        raise AssertionError(f"{label} {arch} {shape}: the "
                                             f"pieces of a block of {k} differ")
            del state
            # AdamW on the mesh's ZeRO-1 blocks, given the unsharded gradients
            placed = sharding.place_params(lm, cfg, mesh)
            state = init_train_state(None, cfg, tc, params=placed)
            grads = {k: sharding.place(g1[k], state.opt["m"][k].spec, mesh)
                     for k in g1}
            adamw_update(grads, state.opt, placed, tc.optimizer)
            param_err = max(float((leaf.full() - p1[k]).detach().abs().max())
                            / float(p1[k].abs().max())
                            for k, leaf in placed.items())
            if not param_err <= MESH_TRAIN_PARAM_TOL:
                raise AssertionError(f"{label} {arch} {shape}: AdamW's "
                                     f"parameters differ by {param_err:.2e}")
            del state, grads
            rec.update(param_err=param_err, step_param_diff=step_diff)
        if not norm_rel <= MESH_TRAIN_NORM_RTOL:
            raise AssertionError(f"{label} {arch} {shape}: grad norm rel "
                                 f"{norm_rel:.2e}")
        rec["norm_rel"] = norm_rel
        del placed
        out.append(rec)
        stepped = ("" if not step else
                   f"AdamW on the mesh given the unsharded gradients "
                   f"{rec['param_err']:.2e} x max|p| <= {MESH_TRAIN_PARAM_TOL}; "
                   f"a whole step's parameters max abs diff "
                   f"{rec['step_param_diff']:.3e}; every block's pieces equal; ")
        phase(label, f"check {cfg.name} {cfg.n_layers} layers at "
              f"full width on {shape} over {MESH_DEVICE} x "
              f"{shape[0] * shape[1]}, one step on ({TRAIN_BATCH}, "
              f"{TRAIN_SEQ}) tokens{'' if ctx is None else ' with ctx_embeds'}"
              f" vs the unsharded port on the card: loss rel {loss_rel:.2e} <= "
              f"{MESH_TRAIN_LOSS_RTOL}; worst gradient {worst_name} "
              f"{grad_err:.2e} x max|g| <= {MESH_TRAIN_GRAD_TOL}; grad norm rel "
              f"{norm_rel:.2e} <= {MESH_TRAIN_NORM_RTOL}; {stepped}launches {ran}")
    del lm, g1, p1
    gc.collect()
    torch.cuda.empty_cache()
    phase(label, f"{cfg.name} checks in {time.perf_counter() - t0:.1f} s")
    return out


def mesh_train_serve(torch, np, configs, M, serve, ssm_mod, sharding, make_mesh,
                     ssd_k, gather_k) -> dict:
    """Phase 16: mamba2 at full width cut to LM_CHECK_LAYERS layers, served
    on MESH_TRAIN_MESH over the card: prefill logits of (LM_SLOTS,
    LM_PROMPT) prompts and MESH_DECODE_STEPS decode steps within
    MESH_LOGIT_RTOL x max|logit| of the unsharded port, greedy tokens past
    the margin; ``ServeEngine`` and ``Batcher(n_slots=LM_SLOTS)`` (every
    admission a b = 1 prefill) on LM_REQUESTS prompts, tokens equal to the
    unsharded continuation past the margin; B8 a head shard."""
    t0 = time.perf_counter()
    cfg = mesh_config(configs, MESH_TRAIN_ARCH, LM_CHECK_LAYERS)
    params = M.init_params(M.make_generator(LM_SEED, DEVICE), cfg)
    prompts = np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT)).astype(np.int32)
    head = prompts[:LM_SLOTS]
    want = greedy_steps(torch, np, M, params, cfg, prompts, LM_NEW_TOKENS)
    want_pre = mesh_prefill(torch, M, params, cfg, head)
    tol = MESH_LOGIT_RTOL * max(1.0, float(want_pre.abs().max()),
                                float(np.abs(want["steps"]).max()))
    mesh = make_mesh(MESH_TRAIN_MESH, ("data", "model"),
                     (MESH_DEVICE,) * (MESH_TRAIN_MESH[0] * MESH_TRAIN_MESH[1]))
    placed = sharding.place_params(params, cfg, mesh)
    before = mesh_train_counts(ssd_k, gather_k)
    got_pre = mesh_prefill(torch, M, placed, cfg, head, mesh)
    scan = "lead" if ssm_mod.head_split(cfg, MESH_TRAIN_MESH[1]) is None else "heads"
    got = greedy_steps(torch, np, M, placed, cfg, head, MESH_DECODE_STEPS + 1,
                       mesh=mesh)
    pre_err = max_err(got_pre, want_pre)
    step_err = float(np.abs(got["steps"] - want["steps"][
        :LM_SLOTS, :MESH_DECODE_STEPS + 1]).max())
    if pre_err > tol or step_err > tol or scan != "heads":
        raise AssertionError(f"mesh-train serve: logits differ by {pre_err:.3e} "
                             f"/ {step_err:.3e} (limit {tol:.3e}), scan {scan}")
    margin_rule(got["tokens"], want["tokens"][:LM_SLOTS, :MESH_DECODE_STEPS + 1],
                want["margins"][:LM_SLOTS], tol, label="mesh-train serve")
    gcfg = serve.GenerationConfig(max_new_tokens=LM_NEW_TOKENS,
                                  cache_len=LM_PROMPT + LM_NEW_TOKENS)
    eng = serve.ServeEngine(cfg, placed, gcfg, mesh=mesh).generate(head)
    margin_rule(eng, want["tokens"][:LM_SLOTS], want["margins"][:LM_SLOTS], tol,
                label="mesh-train engine")
    toks, tps = serve_batcher(torch, serve, cfg, placed, prompts, mesh)
    for rid, t in toks.items():
        margin_rule(np.asarray([t]), want["tokens"][rid:rid + 1],
                    want["margins"][rid:rid + 1], tol,
                    label=f"mesh-train batcher {rid}")
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in mesh_train_counts(ssd_k, gather_k).items()}
    if not (ran["ssd_fused"] and ran["embedding_gather_shard"]):
        raise AssertionError(f"mesh-train serve: launches {ran}")
    phase("mesh-train", f"serve {cfg.name} {cfg.n_layers} layers at full width on "
          f"{MESH_TRAIN_MESH} over {MESH_DEVICE} x 4 (scan: {scan}, B8 on each "
          f"device's {cfg.n_ssm_heads // MESH_TRAIN_MESH[1]} heads): prefill "
          f"({LM_SLOTS}, {LM_PROMPT}) {got['prefill_ms']:.2f} ms, decode "
          f"{got['decode_ms']:.2f} ms a step; logits within {pre_err:.3e} / "
          f"{step_err:.3e} of the unsharded (limit {tol:.3e}); engine and "
          f"batcher ({LM_REQUESTS} requests, {tps:.2f} tokens/s) tokens equal "
          f"to the unsharded past the margin; launches {ran} "
          f"({time.perf_counter() - t0:.1f} s)")
    del params, placed
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": ran, "prefill_err": pre_err, "decode_err": step_err,
            "tokens_per_s": tps, "prefill_ms": got["prefill_ms"],
            "decode_ms": got["decode_ms"]}


def mesh_train_path(torch, np, configs, make_mesh, ssd_k, gather_k) -> dict:
    """Phase 16, the main path: mamba2-2.7b at full width and depth,
    trained TRAIN_STEPS steps of (TRAIN_BATCH, TRAIN_SEQ) tokens on
    MESH_TRAIN_MESH naming the card four times through
    :func:`repro_torch.train.train_loop` (``mesh=``: the state born
    sharded, remat "full", AdamW at TRAIN_LR), the four counts set to 0
    just before and read just after: each step's loss, grad norm and ms,
    tokens/s and the peak device memory beside the unsharded step's."""
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, TrainLoopConfig, train_loop

    t0 = time.perf_counter()
    cfg = configs.get_config(MESH_TRAIN_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    mesh = make_mesh(MESH_TRAIN_MESH, ("data", "model"),
                     (MESH_DEVICE,) * (MESH_TRAIN_MESH[0] * MESH_TRAIN_MESH[1]))
    phase("mesh-train", f"{cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_ssm_heads} SSM heads, vocab {cfg.vocab_size} "
          f"on {MESH_TRAIN_MESH} over {MESH_DEVICE} x 4; device memory before "
          f"init {free / 1e9:.2f} GB free of {total / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR), remat=TRAIN_REMAT)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=LM_SEED)
    lcfg = TrainLoopConfig(total_steps=TRAIN_STEPS, log_every=1, seed=LM_SEED)
    ssd_k.KERNEL_LAUNCHES = ssd_k.BWD_LAUNCHES = 0
    gather_k.SHARD_LAUNCHES = gather_k.SHARD_BWD_LAUNCHES = 0
    gather_k.KERNEL_LAUNCHES = gather_k.BWD_LAUNCHES = 0
    state, hist = train_loop(cfg, tcfg, dcfg, lcfg, mesh=mesh,
                             log=lambda s: print(s, flush=True))
    torch.cuda.synchronize()
    launches = mesh_train_counts(ssd_k, gather_k)
    whole_table = {"embedding_gather": gather_k.KERNEL_LAUNCHES,
                   "embedding_gather_bwd": gather_k.BWD_LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(math.prod(leaf.shape) for _, leaf in state.params.items())
    for h in hist:
        phase("mesh-train", f"step {h['step']}: loss {h['loss']:.6f} grad norm "
              f"{h['grad_norm']:.6f} lr {h['lr']:.3e} {h['wall_s'] * 1e3:.1f} ms")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist):
        raise AssertionError(f"mesh-train: a loss or grad norm is not finite: "
                             f"{hist}")
    if not all(launches.values()):
        raise AssertionError(f"mesh-train: the run launched {launches}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = [h["wall_s"] for h in hist[1:]] or [hist[0]["wall_s"]]
    step_ms = statistics.median(steady) * 1e3
    tps = tokens / statistics.median(steady)
    ms0, tps0, gb0 = MESH_TRAIN_UNSHARDED
    phase("mesh-train", f"{cfg.name} ({n_params / 1e9:.3f} B parameters, fp32) on "
          f"{MESH_TRAIN_MESH}: {len(hist)} steps of ({TRAIN_BATCH}, {TRAIN_SEQ}) "
          f"tokens, remat {TRAIN_REMAT}: step {step_ms:.1f} ms, {tps:.1f} "
          f"tokens/s (median of steps 1+; step 0 {hist[0]['wall_s'] * 1e3:.1f} "
          f"ms), peak device memory {peak:.2f} GB, beside the unsharded step's "
          f"{ms0} ms / {tps0} tokens/s / {gb0} GB (PERF.md section 5); "
          f"launches {launches}"
          f" (whole-table B9 {whole_table}) | {smi_line()}")
    prof = mesh_train_profile(torch, np, state, cfg, tcfg, step_ms)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    phase("mesh-train", f"main path done in {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "hist": hist, "step_ms": step_ms,
            "tokens_per_s": tps, "peak_gb": peak, "cfg": cfg,
            "whole_table": whole_table, "profile": prof}


def mesh_train_profile(torch, np, state, cfg, tcfg, step_ms: float) -> dict:
    """One more step of the main path's state under ``torch.profiler``:
    the card's busy time against the profiled wall and against
    ``step_ms`` (an unprofiled step), the kernels that take most of it,
    and the host's torch ops a step (the mesh's launches are issued by one
    process for every device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import make_train_step

    step = make_train_step(cfg, tcfg)
    batch = mesh_train_batch(np, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev) / 1e3
    host_ops = sum(e.count for e in events if e.device_type == DeviceType.CPU
                   and e.key.startswith("aten::"))
    top = sorted(dev, key=lambda e: e.device_time_total, reverse=True)[:5]
    busy_txt = (f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}% of it; "
                f"{100 * busy / step_ms:.1f}% of an unprofiled step's "
                f"{step_ms:.1f} ms)" if busy > 0
                else "device time not measured (no device events)")
    phase("profile", f"{cfg.name} mesh train step {MESH_TRAIN_MESH} ({TRAIN_BATCH}, "
          f"{TRAIN_SEQ}) remat {tcfg.remat}: wall {wall_ms:.1f} ms under the "
          f"profiler; {busy_txt}; {host_ops} aten ops issued by the host; most "
          "device time: " + "; ".join(
              f"{e.key[:40]} {e.device_time_total / 1e3:.2f} ms x{e.count}"
              for e in top))
    return {"wall_ms": wall_ms, "busy_ms": busy, "step_ms": step_ms,
            "host_aten_ops": host_ops}


def mesh_train_resume(torch, configs, M, make_mesh) -> float:
    """Phase 16: resume on a mesh — the reduced mamba2 on (2, 2) over the
    card, a run crashed at step 2 restarts from its step-2 checkpoint and
    ends within TRAIN_RESUME_TOL of an uninterrupted run; the mesh's
    step-4 checkpoint restores on one device, ``torch.equal``."""
    import shutil

    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, TrainLoopConfig, train_loop

    cfg = configs.reduced_config(MESH_TRAIN_ARCH)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat="full")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=2 * cfg.ssm.chunk,
                      global_batch=4, seed=LM_SEED)
    mesh = make_mesh((2, 2), ("data", "model"), (MESH_DEVICE,) * 4)
    shutil.rmtree(MESH_TRAIN_CKPT, ignore_errors=True)

    def run(name, placement, **kw):
        lcfg = TrainLoopConfig(total_steps=4, ckpt_every=2, log_every=100,
                               ckpt_dir=str(MESH_TRAIN_CKPT / name), seed=LM_SEED)
        return train_loop(cfg, tcfg, dcfg, lcfg, mesh=placement, device=DEVICE,
                          log=lambda s: None, **kw)

    whole, _ = run("whole", mesh)
    try:
        run("crashed", mesh, fail_at_step=2)
        raise AssertionError("mesh resume: the injected failure did not happen")
    except RuntimeError as e:
        if "injected failure at step 2" not in str(e):
            raise
    resumed, hist = run("crashed", mesh)
    if [h["step"] for h in hist] != [2, 3]:
        raise AssertionError(f"mesh resume: steps {[h['step'] for h in hist]}")
    worst = max(float((a.full() - b.full()).detach().abs().max()) for (_, a), (_, b)
                in zip(whole.params.items(), resumed.params.items()))
    if not worst <= TRAIN_RESUME_TOL:
        raise AssertionError(f"mesh resume: parameters differ by {worst}")
    one, hist = run("whole", None)
    equal = not hist and all(torch.equal(p.detach(), whole.params[k].full())
                             for k, p in one.params.named_parameters())
    if not equal:
        raise AssertionError("mesh resume: the mesh checkpoint restored on one "
                             "device differs")
    phase("mesh-train", f"resume on (2, 2) over the card ({cfg.name}, "
          f"{dcfg.global_batch} x {dcfg.seq_len} tokens): crashed at step 2, "
          f"restored the step-2 checkpoint, ran steps 2-3; parameters vs an "
          f"uninterrupted run max abs diff {worst:.3e} <= {TRAIN_RESUME_TOL}; "
          "the mesh's step-4 checkpoint restored on one device torch.equal")
    shutil.rmtree(MESH_TRAIN_CKPT, ignore_errors=True)
    return worst


def time_gather_shard_bwd(torch, np, gather_k, cfg, flush, launches: int,
                          err: float) -> dict:
    """B9's shard backward at the main path's shape: every shard of
    mamba2's table over MESH_TRAIN_MESH's model axis ((12570, 2560) fp32)
    given the train step's (TRAIN_BATCH x TRAIN_SEQ) int64 ids on the card,
    each the median of 10 CUDA-event timings with the L2 flushed.  The
    record is the slowest shard's, beside its bound, its plain version,
    ``zeros + index_add_`` over the masked ids (the library call) and the
    whole-table backward.  Bound: bytes this run's ids need (the shard's
    rows written, the dout rows of the ids it owns and every id read once)
    over HBM_BYTES_PER_S."""
    v, d = cfg.vocab_size, cfg.d_model
    n_shards = MESH_TRAIN_MESH[1]
    rows = v // n_shards
    t = TRAIN_BATCH * TRAIN_SEQ
    ids = torch.from_numpy(mesh_train_batch(np, cfg)["tokens"].reshape(-1)
                           .astype(np.int64)).to(DEVICE)
    dout = torch.randn((t, d), dtype=torch.float32, device=DEVICE)
    bounded = gather_k.clamp_ids(ids, v)
    shards = []
    for s in range(n_shards):
        lo = s * rows
        ms = time_ms(torch, lambda lo=lo: gather_k.embedding_gather_shard_bwd(
            dout, ids, lo, rows, v), flush)
        owned = int(((bounded >= lo) & (bounded < lo + rows)).sum())
        nbytes = (rows + owned) * d * 4 + ids.element_size() * t
        shards.append({"shard": s, "ms": ms, "owned_ids": owned,
                       "bytes": nbytes,
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    worst = max(shards, key=lambda r: r["ms"])
    lo = worst["shard"] * rows
    plain_ms = time_ms(torch, lambda: gather_k.embedding_gather_shard_bwd_ref(
        dout, ids, lo, rows, v), flush)

    def library():
        local = bounded - lo
        own = (local >= 0) & (local < rows)
        return torch.zeros((rows, d), device=DEVICE).index_add_(
            0, local[own], dout[own])
    lib_ms = time_ms(torch, library, flush)
    whole_ms = time_ms(torch, lambda: gather_k.embedding_gather_bwd(dout, ids, v),
                       flush)
    phase("timing", f"B9 shard backward T={t} into each ({rows}, {d}) shard of "
          f"{cfg.name}'s table fp32: " + "; ".join(
              f"shard {r['shard']} {r['ms']:.4f} ms, {r['owned_ids']} ids owned, "
              f"bound {r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB)"
              for r in shards)
          + f" | slowest shard {worst['shard']}: plain {plain_ms:.4f} ms | zeros "
          f"+ index_add_ over the masked ids {lib_ms:.4f} ms | whole-table "
          f"backward {whole_ms:.4f} ms | {smi_line()}")
    return {"name": "embedding_gather_shard_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/embedding_gather.cu",
            "replaces": "src/repro/kernels/gather.py:44 (its vocab-shard form's "
                        "backward: the reference differentiates XLA's gather "
                        "under GSPMD, src/repro/models/model.py:118)",
            "launches": launches, "max_abs_err": err, "ms": worst["ms"],
            "plain_ms": plain_ms, "bound_ms": worst["bound_ms"],
            "bound_by": "bytes", "library_ms": lib_ms, "whole_table_ms": whole_ms,
            "shards": shards,
            "shape": f"T={t} int64 ids (a train step's) into shard "
                     f"{worst['shard']} (the slowest) of {cfg.name}'s table "
                     f"over a {n_shards}-way model axis ({rows}, {d}) fp32"}


def add_mesh_train(kernels: list[dict], mt: dict, shard_bwd: dict) -> None:
    """Phase 16 on the kernels line: its main path's launches of B8, B8's
    backward and B9's shard form under ``launches_by_path["mesh-train"]``,
    and B9's shard backward record."""
    for name in ("ssd_fused", "ssd_fused_bwd", "embedding_gather_shard"):
        rec = next(r for r in kernels if r["name"] == name)
        rec.setdefault("launches_by_path", {"earlier phases": rec["launches"]})
        rec["launches_by_path"]["mesh-train"] = mt["launches"][name]
        rec["launches"] += mt["launches"][name]
    kernels.append(shard_bwd)


def run_mesh_train(torch, np, configs, M, serve, ssm_mod, sharding, make_mesh,
                   ssd_k, gather_k, flush) -> tuple[dict, dict]:
    """Phase 16 whole, as ``main()`` and ``scripts/mesh_train_alone.py`` run
    it: (the main path's readings, B9's shard backward record)."""
    err = compare_gather_shard_bwd(torch, np, gather_k,
                                   configs.get_config(MESH_TRAIN_ARCH))
    checks = mesh_train_check(torch, np, configs, M, sharding, make_mesh,
                              ssd_k, gather_k)
    served = mesh_train_serve(torch, np, configs, M, serve, ssm_mod, sharding,
                              make_mesh, ssd_k, gather_k)
    mt = mesh_train_path(torch, np, configs, make_mesh, ssd_k, gather_k)
    mesh_train_resume(torch, configs, M, make_mesh)
    rec = time_gather_shard_bwd(torch, np, gather_k, mt["cfg"], flush,
                                mt["launches"]["embedding_gather_shard_bwd"], err)
    mt.update(checks=checks, serve=served)
    return mt, rec


# ---------------------------------------------------------------------------
# The mesh-families phase: the hybrid, enc-dec and vision families on a
# (data, model) mesh
# ---------------------------------------------------------------------------


def family_train_cut(cfg):
    """A family's training check at full width: 2 layers (the enc-dec's 2
    encoder and 2 decoder layers), vision its first group (``every`` self
    blocks and their cross block)."""
    if cfg.encdec is not None:
        return dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS,
                                   encdec=dataclasses.replace(
                                       cfg.encdec, encoder_layers=LM_CHECK_LAYERS))
    if cfg.cross_attn is not None:
        return dataclasses.replace(cfg, n_layers=cfg.cross_attn.every)
    return dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS)


def gb_a_device(torch, np, placed) -> float:
    """The parameters' GB on the busiest coordinate of the mesh."""
    mesh = placed.mesh
    per = np.zeros(mesh.devices.shape)
    for _, leaf in placed.items():
        for c in np.ndindex(mesh.devices.shape):
            t = leaf.pieces[c]
            per[c] += t.numel() * t.element_size()
    return float(per.max()) / 1e9


def family_unsharded(torch, np, M, serve, cfg) -> dict:
    """The unsharded model at ``cfg`` from LM_SEED on the card: the
    greedy continuation of LM_REQUESTS prompts against the zero context
    (the batcher's margins), a prefill of the first LM_SLOTS with the stub
    context and a decode step, then, timed, the same prefill and
    MESH_DECODE_STEPS decode steps reading the context back (logits and
    tokens kept on the host), and the batcher's tokens
    and tokens/s; the model is freed before the return."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(M.make_generator(LM_SEED, DEVICE), cfg)
    gb = sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9
    prompts = np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT)).astype(np.int32)
    ctx = family_ctx(np, cfg, LM_SLOTS)
    zero = greedy_steps(torch, np, M, params, cfg, prompts, LM_NEW_TOKENS)
    # the timed call after one at its shapes (a new shape's first call
    # takes seconds more on the card)
    greedy_steps(torch, np, M, params, cfg, prompts[:LM_SLOTS], 2, ctx=ctx)
    want = greedy_steps(torch, np, M, params, cfg, prompts[:LM_SLOTS],
                        MESH_DECODE_STEPS + 1, ctx=ctx, keep_prefill=True)
    toks, tps = serve_batcher(torch, serve, cfg, params, prompts)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    scale = max(1.0, float(want["prefill"].abs().max()),
                float(np.abs(want["steps"]).max()))
    tol = MESH_LOGIT_RTOL * scale
    for rid, t in toks.items():
        margin_rule(np.asarray([t]), zero["tokens"][rid:rid + 1],
                    zero["margins"][rid:rid + 1], tol,
                    label=f"mesh-families {cfg.name} unsharded batcher {rid}")
    return {"prompts": prompts, "ctx": ctx, "zero": zero, "want": want,
            "tokens_per_s": tps, "tol": tol, "gb": gb,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def family_mesh_run(torch, np, M, serve, sharding, make_mesh, ssm_mod, ssd_k,
                    gather_k, cfg, shape, base: dict) -> dict:
    """``cfg`` born sharded from LM_SEED on ``shape`` naming the card data
    x model times, driven with the launch counts set to 0 just before and
    read just after: a prefill of the first LM_SLOTS prompts with the stub
    context and a decode step, then, timed, the same prefill and
    MESH_DECODE_STEPS decode steps (logits within the
    unsharded run's tolerance, greedy tokens equal past the margin), the
    engine with ``extras={"ctx_embeds": ...}`` and the batcher's
    LM_REQUESTS requests against the zero context (tokens equal to the
    unsharded continuation past the margin).  B9 (its shard form, or the
    whole table where the vocabulary does not divide) must have launched,
    and B8 for hymba."""
    n_dev = shape[0] * shape[1]
    mesh = make_mesh(shape, ("data", "model"), (MESH_DEVICE,) * n_dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed = M.init_params(M.make_generator(LM_SEED, DEVICE), cfg, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gb = gb_a_device(torch, np, placed)
    prompts, ctx, want, tol = base["prompts"], base["ctx"], base["want"], base["tol"]
    head = prompts[:LM_SLOTS]
    for k in ("KERNEL_LAUNCHES", "BWD_LAUNCHES"):
        setattr(ssd_k, k, 0)
    for k in ("KERNEL_LAUNCHES", "SHARD_LAUNCHES", "BWD_LAUNCHES",
              "SHARD_BWD_LAUNCHES"):
        setattr(gather_k, k, 0)
    greedy_steps(torch, np, M, placed, cfg, head, 2, mesh=mesh, ctx=ctx)
    got = greedy_steps(torch, np, M, placed, cfg, head, MESH_DECODE_STEPS + 1,
                       mesh=mesh, ctx=ctx, keep_prefill=True)
    pre_err = max_err(got["prefill"], want["prefill"])
    step_err = float(np.abs(got["steps"] - want["steps"]).max())
    if not (pre_err <= tol and step_err <= tol):
        raise AssertionError(
            f"mesh-families {cfg.name} {shape}: logits differ by {pre_err:.3e} "
            f"(prefill) / {step_err:.3e} (decode) > {tol:.3e}")
    checked, close = margin_rule(got["tokens"], want["tokens"], want["margins"],
                                 tol, label=f"mesh-families {cfg.name} {shape}")
    gcfg = serve.GenerationConfig(max_new_tokens=MESH_DECODE_STEPS + 1,
                                  cache_len=LM_PROMPT + LM_NEW_TOKENS)
    eng = serve.ServeEngine(cfg, placed, gcfg, mesh=mesh).generate(
        head, extras=None if ctx is None else {"ctx_embeds": ctx})
    margin_rule(eng, want["tokens"], want["margins"], tol,
                label=f"mesh-families {cfg.name} {shape} engine")
    toks, tps = serve_batcher(torch, serve, cfg, placed, prompts, mesh)
    zero = base["zero"]
    for rid, t in toks.items():
        margin_rule(np.asarray([t]), zero["tokens"][rid:rid + 1],
                    zero["margins"][rid:rid + 1], tol,
                    label=f"mesh-families {cfg.name} {shape} batcher {rid}")
    torch.cuda.synchronize()
    ran = all_lm_counts(ssd_k, gather_k)
    b9 = ran["embedding_gather"] + ran["embedding_gather_shard"]
    if b9 == 0 or (cfg.ssm is not None and ran["ssd_fused"] == 0):
        raise AssertionError(f"mesh-families {cfg.name} {shape}: launches {ran}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    scan = ""
    if cfg.ssm is not None:
        hd = ssm_mod.head_split(cfg, shape[1])
        scan = (f"; B8 on {hd} of {cfg.n_ssm_heads} heads a device" if hd
                else f"; B8 on all {cfg.n_ssm_heads} heads on the lead")
    run = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": list(shape),
           "prefill_ms": got["prefill_ms"], "decode_ms": got["decode_ms"],
           "tokens_per_s": tps, "gb_a_device": gb, "peak_gb": peak,
           "init_s": init_s, "prefill_err": pre_err, "decode_err": step_err,
           "tol": tol, "launches": ran,
           "unsharded": {"prefill_ms": want["prefill_ms"],
                         "decode_ms": want["decode_ms"],
                         "tokens_per_s": base["tokens_per_s"], "gb": base["gb"],
                         "peak_gb": base["peak_gb"]}}
    u = run["unsharded"]
    phase("mesh-families", f"{cfg.name} ({cfg.n_layers} layers) on {shape} "
          f"(data, model) over {MESH_DEVICE} x {n_dev}, born sharded in "
          f"{init_s:.2f} s: prefill ({LM_SLOTS}, {LM_PROMPT})"
          f"{'' if ctx is None else ' with ctx_embeds'} {got['prefill_ms']:.2f} "
          f"ms, decode {got['decode_ms']:.2f} ms a step of {LM_SLOTS}, batcher "
          f"{tps:.2f} tokens/s, {gb:.2f} GB of parameters a device (peak "
          f"{peak:.2f} GB on the card); unsharded {u['prefill_ms']:.2f} / "
          f"{u['decode_ms']:.2f} ms, {u['tokens_per_s']:.2f} tokens/s, "
          f"{u['gb']:.2f} GB (peak {u['peak_gb']:.2f}); logits within "
          f"{pre_err:.3e} / {step_err:.3e} (limit {tol:.3e}); {len(checked)} "
          f"greedy tokens equal, {len(close)} within the margin; engine and "
          f"batcher tokens equal past the margin; launches {ran}{scan} | "
          f"{smi_line()}")
    del placed
    gc.collect()
    torch.cuda.empty_cache()
    return run


def mesh_families_path(torch, np, configs, M, serve, sharding, make_mesh,
                       ssm_mod, ssd_k, gather_k) -> dict:
    """Phase 17: each of MESH_FAMILY_ARCHS at full width, unsharded first
    (its logits and tokens kept on the host, then freed), then born
    sharded from the same seed on each of MESH_FAMILY_SHAPES
    (:func:`family_mesh_run`; a depth MESH_FAMILY_DEPTH cuts gets an
    unsharded run of its own); then the training checks: hymba's 2-layer
    cut a whole step, the enc-dec's and vision's cuts
    (:func:`family_train_cut`) their loss and gradients with
    ``ctx_embeds``, on each mesh against the unsharded step."""
    out = {"runs": [], "checks": [], "launches": {}}
    for arch in MESH_FAMILY_ARCHS:
        t0 = time.perf_counter()
        full = configs.get_config(arch)
        depths: dict = {}
        for shape in MESH_FAMILY_SHAPES:
            depths.setdefault(MESH_FAMILY_DEPTH.get((arch, shape)), []).append(shape)
        for layers, shapes in depths.items():
            cfg = full if layers is None else dataclasses.replace(full,
                                                                  n_layers=layers)
            base = family_unsharded(torch, np, M, serve, cfg)
            phase("mesh-families", f"{cfg.name}: {cfg.n_layers} layers, d_model "
                  f"{cfg.d_model}, {describe_lm(cfg)}, vocab {cfg.vocab_size}; "
                  f"unsharded ({base['gb']:.2f} GB): prefill ({LM_SLOTS}, "
                  f"{LM_PROMPT}) {base['want']['prefill_ms']:.2f} ms, decode "
                  f"{base['want']['decode_ms']:.2f} ms a step of {LM_SLOTS}, "
                  f"batcher {base['tokens_per_s']:.2f} tokens/s (phase 13 in "
                  f"PERF.md section 5: {MESH_FAMILY_PHASE13[arch]})")
            for shape in shapes:
                out["runs"].append(family_mesh_run(
                    torch, np, M, serve, sharding, make_mesh, ssm_mod, ssd_k,
                    gather_k, cfg, shape, base))
            del base
        phase("mesh-families", f"{full.name} done in "
              f"{time.perf_counter() - t0:.1f} s")
    for arch in MESH_FAMILY_ARCHS:
        cfg = family_train_cut(configs.get_config(arch))
        out["checks"] += mesh_step_check(
            torch, np, M, sharding, make_mesh, ssd_k, gather_k, cfg,
            MESH_FAMILY_SHAPES, arch=arch, label="mesh-families",
            ctx=family_ctx(np, cfg, TRAIN_BATCH), step=cfg.hybrid)
    for rec in out["runs"] + out["checks"]:
        for k, n in rec["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + n
    return out


# ---------------------------------------------------------------------------
# Phase 18: the bf16 forms of B8 and B9, and the paths that run them
# ---------------------------------------------------------------------------


def bf16_violation(torch, got, want, what: str) -> float:
    """Max abs error of a bf16 result against its plain version on the
    same bf16 inputs; raises where an element leaves one bf16 ulp of
    max(|got|, |want|) plus the fp32 form's own tolerance (SSD_TOL fp32 x
    max(1, max|want|)): two float32 sums of different order, each rounded
    once to bf16."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    bound = ulp + SSD_TOL["float32"] * max(1.0, float(w.abs().max()))
    diff = (g - w).abs()
    if bool((diff > bound).any()):
        raise AssertionError(f"{what}: {float((diff / bound).max()):.2f} x "
                             "(one bf16 ulp + the fp32 tolerance)")
    return float(diff.max())


def bf16_ssd_inputs(torch, np, case, seed: int, init: bool):
    """Phase 3's B8 inputs of ``case`` with xd, B and C rounded to bf16
    (ad and the initial state float32): (xd, ad, B, C), init."""
    b, l, h, p, g, n, _, _ = case
    (xd, ad, B, C), s0 = ssd_inputs(torch, np, b, l, h, p, g, n, "float32",
                                    seed=seed, init=init)
    return (xd.bfloat16(), ad, B.bfloat16(), C.bfloat16()), s0


def compare_bf16_ssd(torch, np, ssd_k, cfg, hybrid) -> float:
    """Phase 18 (B8 bf16): phase 3's float32 cases (mamba2's and hymba's
    prefill shapes, three chunks, the small ones) and BF16_SSD_CASES, from
    a zero and a random state: y ``torch.equal`` to the fp32 form's on the
    upcast inputs rounded to bf16, the state ``torch.equal`` to its; the
    plain bf16 version held at one bf16 ulp (+ SSD_TOL) on y and SSD_TOL on
    the state.  Returns the max abs error of y against the plain version."""
    cases = [c for c in ssd_cases(cfg, hybrid) if c[-1] == "float32"]
    worst = 0.0
    for i, case in enumerate(cases + BF16_SSD_CASES):
        q = case[6]
        errs = []
        for init in (False, True):
            (xd, ad, B, C), s0 = bf16_ssd_inputs(torch, np, case, 300 + i, init)
            before = ssd_k.KERNEL_LAUNCHES
            y, f = ssd_k.ssd_fused(xd, ad, B, C, chunk=q, init_state=s0)
            y32, f32 = ssd_k.ssd_fused(xd.float(), ad, B.float(), C.float(),
                                       chunk=q, init_state=s0)
            torch.cuda.synchronize()
            if ssd_k.KERNEL_LAUNCHES - before != 2 * ssd_k.LAUNCHES_PER_CALL:
                raise AssertionError("B8 bf16: not three launches a call")
            if y.dtype != torch.bfloat16 or f.dtype != torch.float32 \
                    or not torch.equal(y, y32.bfloat16()) \
                    or not torch.equal(f, f32):
                raise AssertionError(
                    f"B8 bf16 {case[:7]} init {init}: not the fp32 form's "
                    f"rounded (y max err {max_err(y.float(), y32):.3e}, state "
                    f"{max_err(f, f32):.3e})")
            y0, f0 = ssd_k.ssd_fused_ref(xd, ad, B, C, chunk=q, init_state=s0)
            errs.append(bf16_violation(torch, y, y0, f"B8 bf16 {case[:7]} y"))
            ssd_violation(torch, f, f0, "float32")
        worst = max(worst, max(errs))
        phase("compare", f"B8 bf16 (b, l, h, p, g, n) = {case[:6]} chunk {q}: "
              "y torch.equal to the fp32 form's on the upcast inputs rounded, "
              f"the state torch.equal; plain bf16 version max abs err y "
              f"{max(errs):.3e} (zero and random initial state)")
    return worst


def compare_bf16_ssd_bwd(torch, np, ssd_k, cfg, hybrid) -> float:
    """Phase 18 (B8's backward bf16): phase 14's float32 cases, from a zero
    and a random state, with and without a final-state gradient: dxd, dB
    and dC ``torch.equal`` to the fp32 backward's on the upcast inputs
    rounded, dad and d init_state equal; the plain bf16 backward held at
    one bf16 ulp (+ SSD_TOL) / SSD_TOL.  Returns the max abs error against
    the plain version."""
    worst = 0.0
    cases = [c for c in ssd_bwd_cases(cfg, hybrid) if c[-1] == "float32"]
    for i, case in enumerate(cases):
        b, l, h, p, g, n, q, _ = case
        for init, fin in ((False, False), (False, True), (True, True)):
            (xd, ad, B, C), s0 = bf16_ssd_inputs(torch, np, case, 400 + i, init)
            rng = np.random.default_rng(500 + i)
            dy = torch.from_numpy(rng.standard_normal((b, l, h, p)).astype(
                np.float32)).to(DEVICE).bfloat16()
            df = (torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(
                np.float32)).to(DEVICE) if fin else None)
            before = ssd_k.BWD_LAUNCHES
            got = ssd_k.ssd_fused_bwd(xd, ad, B, C, dy, df, chunk=q,
                                      init_state=s0)
            want = ssd_k.ssd_fused_bwd(xd.float(), ad, B.float(), C.float(),
                                       dy.float(), df, chunk=q, init_state=s0)
            torch.cuda.synchronize()
            if ssd_k.BWD_LAUNCHES - before != 2 * ssd_k.LAUNCHES_PER_BWD:
                raise AssertionError("B8 backward bf16: not five launches a call")
            plain = ssd_k.ssd_fused_bwd_ref(xd, ad, B, C, dy, df, chunk=q,
                                            init_state=s0)
            for name, gv, wv, pv in zip(("dxd", "dad", "dB", "dC", "dinit"),
                                        got, want, plain):
                if gv is None:
                    continue
                if not torch.equal(gv, wv.to(gv.dtype)):
                    raise AssertionError(
                        f"B8 backward bf16 {case[:7]} {name}: not the fp32 "
                        f"backward's rounded ({max_err(gv.float(), wv):.3e})")
                if gv.dtype == torch.bfloat16:
                    worst = max(worst, bf16_violation(
                        torch, gv, pv, f"B8 backward bf16 {case[:7]} {name}"))
                else:
                    worst = max(worst, ssd_violation(torch, gv, pv, "float32"))
        phase("compare", f"B8 backward bf16 (b, l, h, p, g, n) = {case[:6]} chunk "
              f"{q}: dxd, dB, dC torch.equal to the fp32 backward's on the upcast "
              "inputs rounded once, dad and d init_state equal, from a zero and a "
              "random state, with and without a final-state gradient; plain bf16 "
              f"backward max abs err {worst:.3e}")
    return worst


def bf16_gather_ids(torch, np, v: int, t: int, id_dtype, seed: int):
    """(t,) ids on the card with repeats (every fifth the first) and, past
    the first slots, the out-of-range card ids of :func:`compare_gather`."""
    ids = np.random.default_rng(seed).integers(0, v, t)
    ids[::5] = ids[0]
    raw = [v, v + 7, -1, -v - 3, 2**31 - 1, 0, v - 1]
    if id_dtype == torch.int64:
        raw += [2**31, -2**31 - 5]
    if t >= 2 * len(raw):
        ids[1:1 + len(raw)] = raw
    return torch.tensor(ids, dtype=id_dtype, device=DEVICE)


def compare_bf16_gather(torch, np, gather_k, cfg) -> dict:
    """Phase 18 (B9's four bf16 entries) on mamba2's (V, d) table in bf16 and
    a bf16 table of odd d, at BF16_GATHER_TS, int32 / int64 ids on the host
    and on the card with the out-of-range card ids of phase 3: the gather
    ``torch.equal`` to ``table[clamp_ids(ids)]``, one launch a call; the
    shard form on 4 row shards equal to the masked rows, the shards summing
    to the whole-table gather; the backward from bf16 and from float32
    output gradients, and the shard backward, ``torch.equal`` to their
    plain versions (``embedding_gather_bwd_ref`` / ``_shard_bwd_ref`` with
    ``dtype=bfloat16``) on the same card inputs and to the fp32 backward's
    of the same (upcast) gradients rounded once, the shards stacked equal
    to the whole-table backward.  Returns each entry's max abs error
    against its plain version, by the kernels line's record name."""
    v, d = cfg.vocab_size, cfg.d_model
    n_fwd = n_bwd = 0
    errs = dict.fromkeys(("embedding_gather_bf16", "embedding_gather_shard_bf16",
                          "embedding_gather_bwd_bf16",
                          "embedding_gather_shard_bwd_bf16"), 0.0)

    def err(name, got, want):
        errs[name] = max(errs[name], max_err(got.float(), want.float()))
    rng = np.random.default_rng(17)
    for vv, dd in ((v, d), BF16_ODD_TABLE):
        table = torch.randn((vv, dd), dtype=torch.float32, device=DEVICE).bfloat16()
        rows = vv // MESH_GATHER_SHARDS
        for t in BF16_GATHER_TS:
            for id_dtype in (torch.int32, torch.int64):
                host = rng.integers(0, vv, t).astype(
                    np.int32 if id_dtype == torch.int32 else np.int64)
                card = bf16_gather_ids(torch, np, vv, t, id_dtype, t)
                for ids in (host, card):
                    before = gather_k.KERNEL_LAUNCHES
                    got = gather_k.embedding_gather(table, ids)
                    torch.cuda.synchronize()
                    want = table[gather_k.clamp_ids(torch.as_tensor(ids).to(DEVICE), vv)]
                    err("embedding_gather_bf16", got, want)
                    if gather_k.KERNEL_LAUNCHES != before + 1 or not torch.equal(got, want):
                        raise AssertionError(f"B9 bf16 ({vv}, {dd}) T={t} "
                                             f"{id_dtype}: not table[ids]")
                    n_fwd += 1
                total = None
                for k in range(MESH_GATHER_SHARDS):
                    shard = table[k * rows:(k + 1) * rows]
                    got = gather_k.embedding_gather_shard(shard, card, k * rows, vv)
                    want = gather_k.embedding_gather_shard_ref(shard, card, k * rows, vv)
                    err("embedding_gather_shard_bf16", got, want)
                    if not torch.equal(got, want):
                        raise AssertionError(f"B9 shard bf16 ({vv}, {dd}) k={k} "
                                             f"T={t}: not the masked rows")
                    total = got if total is None else total + got
                    n_fwd += 1
                if not torch.equal(total, gather_k.embedding_gather(table, card)):
                    raise AssertionError(f"B9 shard bf16 T={t}: the shards do not "
                                         "sum to the whole gather")
                dout = torch.randn((t, dd), dtype=torch.float32, device=DEVICE)
                doutb = dout.bfloat16()
                before = (gather_k.BWD_LAUNCHES, gather_k.SHARD_BWD_LAUNCHES)
                for src, wide in ((doutb, doutb.float()), (dout, dout)):
                    got = gather_k.embedding_gather_bwd(src, card, vv,
                                                        dtype=torch.bfloat16)
                    want = gather_k.embedding_gather_bwd(wide, card, vv)
                    plain = gather_k.embedding_gather_bwd_ref(src, card, vv,
                                                              dtype=torch.bfloat16)
                    err("embedding_gather_bwd_bf16", got, plain)
                    if got.dtype != torch.bfloat16 or not torch.equal(got, plain):
                        raise AssertionError(
                            f"B9 backward bf16 ({vv}, {dd}) T={t} {id_dtype} from "
                            f"{src.dtype}: not its plain version")
                    if not torch.equal(got, want.bfloat16()):
                        raise AssertionError(
                            f"B9 backward bf16 ({vv}, {dd}) T={t} {id_dtype} from "
                            f"{src.dtype}: not the fp32 backward's rounded")
                    del want, plain
                    parts = []
                    for k in range(MESH_GATHER_SHARDS):
                        part = gather_k.embedding_gather_shard_bwd(
                            src, card, k * rows, rows, vv, dtype=torch.bfloat16)
                        want_k = gather_k.embedding_gather_shard_bwd(
                            wide, card, k * rows, rows, vv)
                        plain_k = gather_k.embedding_gather_shard_bwd_ref(
                            src, card, k * rows, rows, vv, dtype=torch.bfloat16)
                        err("embedding_gather_shard_bwd_bf16", part, plain_k)
                        if not torch.equal(part, plain_k):
                            raise AssertionError(
                                f"B9 shard backward bf16 k={k} T={t} from "
                                f"{src.dtype}: not its plain version")
                        if not torch.equal(part, want_k.bfloat16()):
                            raise AssertionError(
                                f"B9 shard backward bf16 k={k} T={t} from "
                                f"{src.dtype}: not the fp32 one's rounded")
                        parts.append(part)
                    if not torch.equal(torch.cat(parts), got):
                        raise AssertionError(f"B9 shard backward bf16 T={t}: the "
                                             "shards stacked are not the whole")
                    n_bwd += 1 + MESH_GATHER_SHARDS
                torch.cuda.synchronize()
                ran = (gather_k.BWD_LAUNCHES - before[0],
                       gather_k.SHARD_BWD_LAUNCHES - before[1])
                if ran != (4, 4 * MESH_GATHER_SHARDS):
                    raise AssertionError(f"B9 backward bf16: launches {ran}")
        del table
    phase("compare", f"B9 bf16 on ({v}, {d}) and {BF16_ODD_TABLE} tables, T in "
          f"{BF16_GATHER_TS}, int32 / int64 ids on the host and on the card (card "
          f"ids outside [0, V)): {n_fwd} gathers / shard gathers torch.equal to "
          f"table[clamp_ids(ids)] / the masked rows, one launch a call; {n_bwd} "
          "backwards / shard backwards from bf16 and from float32 dout "
          "torch.equal to their plain versions on the same inputs and to the "
          "fp32 backward's rounded once, the shards summing / stacking to the "
          f"whole; max abs err vs the plain versions {errs}")
    return errs


def copy_then_gather(torch, gather_k):
    """The model's embedding before B9's bf16 form: a bf16 table copied to
    float32, then gathered (the copy's backward casts the float32 sums to
    bf16 once): what ``models.model._embed`` must equal."""
    def embed(p, cfg, tokens, dtype):
        b, s = tokens.shape
        table = p.tok_embed
        if table.dtype not in (torch.float32, torch.float64):
            table = table.float()
        x = gather_k.embedding_gather(table, tokens.reshape(-1))
        return x.reshape(b, s, cfg.d_model).to(dtype)
    return embed


def bf16_serve(torch, np, configs, M, serve, ssd_k, gather_k) -> dict:
    """Phase 18's serving path (``SSD_BF16`` set by the caller): mamba2-2.7b
    at full width and depth, random init from LM_SEED, its parameters in
    bf16 (the embedding table gathered by B9's bf16 form), served by
    ``Batcher(n_slots=LM_SLOTS)``: BF16_REQUESTS requests of LM_PROMPT
    tokens, BF16_NEW_TOKENS new each, every prefill B8's bf16 form in each
    layer; B8's and B9's counts set to 0 just before and read just after.
    Then the 2-layer full-width card-vs-CPU check at BF16_LOGIT_RTOL."""
    cfg = lm_config(configs)
    t0 = time.perf_counter()
    params = M.init_params(M.make_generator(LM_SEED, DEVICE), cfg).to(torch.bfloat16)
    torch.cuda.synchronize()
    if params.tok_embed.dtype != torch.bfloat16:
        raise AssertionError("bf16: the table is not bf16")
    n_params = sum(t.numel() for t in params.parameters())
    phase("bf16", f"{cfg.name}: {cfg.n_layers} layers, {describe_lm(cfg)}: "
          f"{n_params:,} parameters in bf16 ({2 * n_params / 1e9:.2f} GB), random "
          f"init (seed {LM_SEED}) in {time.perf_counter() - t0:.1f} s; SSD_BF16")
    rng = np.random.default_rng(LM_SEED + 18)
    prompts = rng.integers(0, cfg.vocab_size,
                           (BF16_REQUESTS, LM_PROMPT)).astype(np.int32)
    gcfg = serve.GenerationConfig(max_new_tokens=BF16_NEW_TOKENS,
                                  cache_len=LM_PROMPT + BF16_NEW_TOKENS)
    batcher = timed_batcher(torch, serve)(cfg, params, n_slots=LM_SLOTS, gcfg=gcfg)
    for rid in range(BF16_REQUESTS):
        batcher.submit(serve.Request(rid=rid, prompt=prompts[rid],
                                     max_new_tokens=BF16_NEW_TOKENS))
    torch.cuda.synchronize()
    ssd_k.KERNEL_LAUNCHES = 0
    gather_k.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    done = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b8, b9 = ssd_k.KERNEL_LAUNCHES, gather_k.KERNEL_LAUNCHES
    steps = len(batcher.decode_s)
    if len(done) != BF16_REQUESTS or any(
            len(r.generated) != BF16_NEW_TOKENS
            or not all(0 <= t < cfg.vocab_size for t in r.generated) for r in done):
        raise AssertionError("bf16 batcher: a request is missing, short or out "
                             "of the vocabulary")
    if b8 != BF16_REQUESTS * cfg.n_layers * ssd_k.LAUNCHES_PER_CALL \
            or b9 != BF16_REQUESTS + steps:
        raise AssertionError(f"bf16 batcher launches B8 {b8}, B9 {b9}")
    n_tok = sum(len(r.generated) for r in done)
    prefill_ms = 1e3 * statistics.median(batcher.prefill_s)
    decode_ms = 1e3 * statistics.median(batcher.decode_s)
    phase("bf16", f"Batcher(n_slots={LM_SLOTS}), bf16 weights, SSD_BF16: "
          f"{BF16_REQUESTS} requests x {LM_PROMPT}-token prompts, {n_tok} tokens "
          f"in {wall:.3f} s = {n_tok / wall:.2f} tokens/s; prefill "
          f"{prefill_ms:.2f} ms a request (median, b = 1), decode "
          f"{decode_ms:.2f} ms a step (median of {steps}); B8 bf16 launches {b8}, "
          f"B9 bf16 launches {b9} | {smi_line()}")
    rel = lm_check(torch, np, M, {"cfg": cfg, "params": params,
                                  "prompts": prompts},
                   label="bf16", rtol=BF16_LOGIT_RTOL)
    del params, batcher
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {"ssd_fused": b8, "embedding_gather": b9},
            "tokens_per_s": n_tok / wall, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "logit_rel_err": rel}


def bf16_train(torch, np, configs, ssd_k, gather_k) -> dict:
    """Phase 18's training path (``SSD_BF16`` set by the caller):
    mamba2-2.7b at full width and depth trained BF16_TRAIN_STEPS steps of
    (TRAIN_BATCH, TRAIN_SEQ) by :func:`repro_torch.train.train_loop` with
    ``TrainConfig(param_dtype=torch.bfloat16)`` and the CLI's other
    settings (remat "full", TRAIN_LR, the synthetic stream from LM_SEED),
    the four counts set to 0 just before and read just after: each step's
    loss and ms, tokens/s, the peak device memory."""
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, TrainLoopConfig, train_loop

    cfg = train_config(configs)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR), remat=TRAIN_REMAT,
                       param_dtype=torch.bfloat16)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=LM_SEED)
    lcfg = TrainLoopConfig(total_steps=BF16_TRAIN_STEPS, log_every=10,
                           seed=LM_SEED)
    ssd_k.KERNEL_LAUNCHES = ssd_k.BWD_LAUNCHES = 0
    gather_k.KERNEL_LAUNCHES = gather_k.BWD_LAUNCHES = 0
    state, hist = train_loop(cfg, tcfg, dcfg, lcfg, device=DEVICE,
                             log=lambda s: print(s, flush=True))
    torch.cuda.synchronize()
    launches = train_counts(ssd_k, gather_k)
    peak = torch.cuda.max_memory_allocated() / 1e9
    table = dict(state.params.named_parameters())["tok_embed"]
    if table.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 train: the table is {table.dtype}")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist):
        raise AssertionError(f"bf16 train: a loss or grad norm is not finite: {hist}")
    if not all(launches.values()):
        raise AssertionError(f"bf16 train: the run launched {launches}")
    steady = [h["wall_s"] for h in hist[1:]] or [hist[0]["wall_s"]]
    tps = TRAIN_BATCH * TRAIN_SEQ / statistics.median(steady)
    phase("bf16", f"{cfg.name} trained {len(hist)} steps of ({TRAIN_BATCH}, "
          f"{TRAIN_SEQ}) with bf16 parameters and SSD_BF16, remat {TRAIN_REMAT}: "
          + "; ".join(f"step {h['step']} loss {h['loss']:.6f} "
                      f"{h['wall_s'] * 1e3:.1f} ms" for h in hist)
          + f"; {tps:.1f} tokens/s; peak device memory {peak:.2f} GB; launches "
          f"(all bf16 forms) {launches}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": [h["wall_s"] * 1e3 for h in hist],
            "tokens_per_s": tps, "peak_gb": peak}


def bf16_train_check(torch, np, M, ssm_mod, sharding, make_mesh, ssd_k,
                     gather_k, cfg) -> dict:
    """Phase 18's checks of a step: a LM_CHECK_LAYERS-layer full-width cut,
    bf16 parameters from LM_SEED on the CPU and copied to the card.  Under
    ``SSD_BF16`` the card's loss and gradients against the CPU's (loss
    TRAIN_LOSS_RTOL, gradients BF16_GRAD_TOL x max|g|); with it off, the
    card's step ``torch.equal`` to :func:`copy_then_gather`'s; on a (1, 4)
    mesh naming the card (``SSD_BF16``: B8's bf16 form a head shard) B9's
    shard forms counted from 0, their gradient rows stacked
    ``torch.equal`` to the whole-table backward of the same output
    gradients."""
    from repro_torch.train import TrainConfig
    from repro_torch.train.step import loss_and_grads

    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS)
    cpu = M.init_params(M.make_generator(LM_SEED, "cpu"), cfg2,
                        trainable=True).to(torch.bfloat16)
    card = copy.deepcopy(cpu).to(DEVICE)
    batch = train_batch(np, cfg2, TRAIN_CHECK_BATCH)
    tc = TrainConfig(remat=None)
    ssm_mod.SSD_BF16 = True
    before = train_counts(ssd_k, gather_k)
    g_card, l_card, _ = loss_and_grads(card, cfg2, tc, batch)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in train_counts(ssd_k, gather_k).items()}
    if not all(ran.values()):
        raise AssertionError(f"bf16 train check: the card's step launched {ran}")
    g_cpu, l_cpu, _ = loss_and_grads(cpu, cfg2, tc, batch)
    rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"bf16 train check: loss {float(l_card)} vs CPU "
                             f"{float(l_cpu)} ({rel:.2e} > {TRAIN_LOSS_RTOL})")
    worst, worst_name = 0.0, ""
    for k, gc_ in g_cpu.items():
        scale = max(float(gc_.float().abs().max()), 1e-30)
        e = float((g_card[k].cpu().float() - gc_.float()).abs().max()) / scale
        if not e <= BF16_GRAD_TOL:
            raise AssertionError(f"bf16 train check: gradient {k} differs by "
                                 f"{e:.2e} x max|g| > {BF16_GRAD_TOL}")
        if e >= worst:
            worst, worst_name = e, k
    del cpu, g_cpu
    # SSD_BF16 off: the bf16 table's step equals the copy-then-gather one
    ssm_mod.SSD_BF16 = False
    g_new, l_new, _ = loss_and_grads(card, cfg2, tc, batch)
    embed = M._embed
    M._embed = copy_then_gather(torch, gather_k)
    try:
        g_old, l_old, _ = loss_and_grads(card, cfg2, tc, batch)
    finally:
        M._embed = embed
    if not torch.equal(l_new, l_old) or any(
            not torch.equal(g, g_old[k]) for k, g in g_new.items()):
        raise AssertionError("bf16 train check: the bf16 table's step is not "
                             "the copy-then-gather step's")
    del g_new, g_old
    # (1, 4): B9's shard forms on the vocab-sharded bf16 table
    ssm_mod.SSD_BF16 = True
    mesh = make_mesh((1, 4), ("data", "model"), (DEVICE,) * 4)
    placed = sharding.place_params(card, cfg2, mesh)
    seen = []
    shard_bwd = gather_k.embedding_gather_shard_bwd

    def spy(dout, ids, lo, rows, vocab, *, dtype=None):
        out = shard_bwd(dout, ids, lo, rows, vocab, dtype=dtype)
        seen.append((dout, ids, lo, out))
        return out
    gather_k.embedding_gather_shard_bwd = spy
    gather_k.SHARD_LAUNCHES = gather_k.SHARD_BWD_LAUNCHES = 0
    try:
        _, l_mesh, _ = loss_and_grads(placed, cfg2, tc, batch)
        torch.cuda.synchronize()
    finally:
        gather_k.embedding_gather_shard_bwd = shard_bwd
    shard_launches = {"embedding_gather_shard": gather_k.SHARD_LAUNCHES,
                      "embedding_gather_shard_bwd": gather_k.SHARD_BWD_LAUNCHES}
    if tuple(shard_launches.values()) != (4, 4) or len(seen) != 4:
        raise AssertionError(f"bf16 mesh step: shard launches {shard_launches}")
    seen.sort(key=lambda e: e[2])
    dout, ids = seen[0][0], seen[0][1]
    if seen[0][3].dtype != torch.bfloat16 or any(
            not torch.equal(e[0].to(dout.device), dout) for e in seen):
        raise AssertionError("bf16 mesh step: the shards' output gradients differ")
    whole = gather_k.embedding_gather_bwd(dout, ids.to(dout.device), cfg2.vocab_size,
                                          dtype=torch.bfloat16)
    if not torch.equal(torch.cat([e[3].to(dout.device) for e in seen]), whole):
        raise AssertionError("bf16 mesh step: the shard backward's rows are not "
                             "the whole-table backward's")
    mesh_rel = abs(float(l_mesh) - float(l_card)) / abs(float(l_card))
    del placed, seen, card, g_card
    gc.collect()
    torch.cuda.empty_cache()
    phase("bf16", f"check: {LM_CHECK_LAYERS} layers at full width, bf16 "
          f"parameters, one step on ({TRAIN_CHECK_BATCH}, {TRAIN_SEQ}) tokens: "
          f"SSD_BF16 card vs CPU loss {float(l_card):.6f} vs {float(l_cpu):.6f} "
          f"(rel {rel:.2e} <= {TRAIN_LOSS_RTOL}), worst gradient {worst_name} "
          f"{worst:.2e} x max|g| <= {BF16_GRAD_TOL}, launches {ran}; SSD_BF16 off: "
          "loss and every gradient torch.equal to the copy-then-gather step; "
          f"(1, 4) over {DEVICE} x 4: shard launches {shard_launches}, the shard "
          "backward's rows stacked torch.equal to the whole-table backward of "
          f"the same dout, loss rel {mesh_rel:.2e} of the unsharded "
          f"({time.perf_counter() - t0:.1f} s)")
    return {"loss_rel": rel, "grad_err": worst, "launches": shard_launches}


def time_bf16(torch, np, ssd_k, gather_k, cfg, flush) -> dict:
    """Phase 18 (timing): each bf16 form at its path's shape beside its fp32
    form in the same run (median of 10 CUDA-event timings after 2, the L2
    flushed), its bound, its plain version and, where one PyTorch call
    computes the same function, that call: B8 at the batcher's prefill (1,
    LM_PROMPT), its backward at the train step's (TRAIN_BATCH, TRAIN_SEQ),
    B9 and its shard form (shard 0 of MESH_GATHER_SHARDS) at LM_PROMPT card
    ids, their backwards at the train step's ids (the model's float32 dout
    into the bf16 table, the form its path runs; bf16 dout beside it)."""
    from repro_torch.core import autotune

    embed = torch.nn.functional.embedding
    s = cfg.ssm
    l, h, p, g, n, q = (LM_PROMPT, cfg.n_ssm_heads, s.head_dim, s.n_groups,
                        s.d_state, s.chunk)
    out = {}
    # B8, forward and backward
    for b, name in ((1, "ssd_fused_bf16"), (TRAIN_BATCH, "ssd_fused_bwd_bf16")):
        case = (b, l, h, p, g, n, q, "float32")
        (xd, ad, B, C), _ = bf16_ssd_inputs(torch, np, case, 11, False)
        up = (xd.float(), ad, B.float(), C.float())
        if name == "ssd_fused_bf16":
            ms = time_ms(torch, lambda: ssd_k.ssd_fused(xd, ad, B, C, chunk=q), flush)
            fp32_ms = time_ms(torch, lambda: ssd_k.ssd_fused(*up, chunk=q), flush)
            plain_ms = time_ms(torch, lambda: ssd_k.ssd_fused_ref(xd, ad, B, C,
                                                                   chunk=q), flush)
            flops = autotune.ssd_flops(b, l, h, p, n, q)
            nbytes = 2 * (2 * b * l * h * p + 2 * b * l * g * n) \
                + 4 * (b * l * h + b * h * p * n)
        else:
            dy = torch.randn_like(xd)
            _, fs, cum, ent = ssd_k._forward(xd, ad, B, C, q, None, keep=True)
            _, fs32, cum32, ent32 = ssd_k._forward(*up, q, None, keep=True)
            ms = time_ms(torch, lambda: ssd_k.ssd_fused_bwd(
                xd, ad, B, C, dy, chunk=q, saved=(fs, cum, ent)), flush)
            fp32_ms = time_ms(torch, lambda: ssd_k.ssd_fused_bwd(
                *up, dy.float(), chunk=q, saved=(fs32, cum32, ent32)), flush)
            plain_ms = time_ms(torch, lambda: ssd_k.ssd_fused_bwd_ref(
                xd, ad, B, C, dy, chunk=q), flush)
            flops = autotune.ssd_bwd_flops(b, l, h, p, n, q)
            nc = l // q
            nbytes = 2 * (3 * b * l * h * p + 4 * b * l * g * n) \
                + 4 * (2 * b * l * h + b * h * l + b * h * nc * p * n + b * h * p * n)
        ops_ms = flops / FP32_OPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "fp32_ms": fp32_ms, "plain_ms": plain_ms,
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                     "library_ms": None,
                     "shape": f"(b, l, h, p, g, n) = {(b, l, h, p, g, n)} chunk "
                              f"{q}, bf16 xd / B / C, float32 ad"}
        phase("timing", f"B8{' backward' if 'bwd' in name else ''} bf16 (b, l, h, "
              f"p, g, n) = {(b, l, h, p, g, n)} chunk {q}: {ms:.4f} ms (fp32 form "
              f"{fp32_ms:.4f} ms) | bound {max(ops_ms, bytes_ms):.4f} ms (ops "
              f"{ops_ms:.4f}: {flops / 1e9:.3f} GFLOP at 67 TFLOP/s; bytes "
              f"{bytes_ms:.4f}) | plain {plain_ms:.4f} ms | no single PyTorch call")
        del xd, ad, B, C, up
    # B9 and its shard form
    v, d = cfg.vocab_size, cfg.d_model
    t32 = torch.randn((v, d), dtype=torch.float32, device=DEVICE)
    table = t32.bfloat16()
    t = LM_PROMPT
    ids = torch.from_numpy(np.random.default_rng(t).integers(0, v, t)).to(DEVICE)
    chunks, threads = autotune.gather_grid(t, d * 2)
    dst = torch.empty((t, d), dtype=torch.bfloat16, device=DEVICE)
    rec = {"ms": time_ms(torch, lambda: gather_k.embedding_gather(table, ids), flush),
           "fp32_ms": time_ms(torch, lambda: gather_k.embedding_gather(t32, ids), flush),
           "launch_ms": time_ms(torch, lambda: gather_k._launch(
               table, ids, dst, chunks, threads), flush),
           "plain_ms": time_ms(torch, lambda: gather_k.embedding_gather_ref(table, ids),
                               flush),
           "library_ms": time_ms(torch, lambda: embed(ids, table), flush),
           "bound_ms": (2 * t * d * 2 + 8 * t) / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes",
           "shape": f"T={t} int64 ids on the card from ({v}, {d}) bf16"}
    out["embedding_gather_bf16"] = rec
    rows = v // MESH_GATHER_SHARDS
    shard = table[:rows]
    sids = gather_shard_ids(torch, np, v, MESH_GATHER_SHARDS, t, torch.int64, t)
    owned = int((gather_k.clamp_ids(sids, v) < rows).sum())
    srec = {"ms": time_ms(torch, lambda: gather_k.embedding_gather_shard(
                shard, sids, 0, v), flush),
            "fp32_ms": time_ms(torch, lambda: gather_k.embedding_gather_shard(
                t32[:rows], sids, 0, v), flush),
            "plain_ms": time_ms(torch, lambda: gather_k.embedding_gather_shard_ref(
                shard, sids, 0, v), flush),
            "library_ms": None,
            "bound_ms": ((t + owned) * d * 2 + 8 * t) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "shape": f"T={t} card ids on shard 0 ({rows}, {d}) bf16 of ({v}, {d}), "
                     f"{owned} owned"}
    out["embedding_gather_shard_bf16"] = srec
    for name, r in (("B9", rec), ("B9 shard", srec)):
        phase("timing", f"{name} bf16 {r['shape']}: {r['ms']:.4f} ms (fp32 form "
              f"{r['fp32_ms']:.4f} ms" + (f"; launch alone {r['launch_ms']:.4f} ms"
                                         if "launch_ms" in r else "")
              + f") | bound {r['bound_ms']:.5f} ms (bytes) | plain "
              f"{r['plain_ms']:.4f} ms | " + ("F.embedding on the bf16 table "
                                              f"{r['library_ms']:.4f} ms"
                                              if r["library_ms"] is not None
                                              else "no single PyTorch call"))
    # the backwards at the train step's ids: the path's form (the model's
    # float32 dout into the bf16 table) is the record's ms, bound, plain and
    # library time; the bf16-dout form, which no path runs, is timed beside it
    t = TRAIN_BATCH * TRAIN_SEQ
    ids = torch.from_numpy(train_batch(np, cfg, TRAIN_BATCH)["tokens"].reshape(-1)
                           .astype(np.int64)).to(DEVICE)
    dout = torch.randn((t, d), dtype=torch.float32, device=DEVICE)
    doutb = dout.bfloat16()
    bf16 = torch.bfloat16
    brec = {"ms": time_ms(torch, lambda: gather_k.embedding_gather_bwd(
                dout, ids, v, dtype=bf16), flush),
            "bf16_dout_ms": time_ms(torch, lambda: gather_k.embedding_gather_bwd(
                doutb, ids, v), flush),
            "fp32_ms": time_ms(torch, lambda: gather_k.embedding_gather_bwd(
                dout, ids, v), flush),
            "plain_ms": time_ms(torch, lambda: gather_k.embedding_gather_bwd_ref(
                dout, ids, v, dtype=bf16), flush, runs=3, warmup=1),
            "library_ms": time_ms(torch, lambda: torch.zeros(
                (v, d), dtype=torch.float32, device=DEVICE).index_add_(
                0, ids, dout).to(bf16), flush),
            "bound_ms": (v * d * 2 + t * d * 4 + 8 * t) / HBM_BYTES_PER_S * 1e3,
            "bf16_dout_bound_ms": ((v * d + t * d) * 2 + 8 * t)
            / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "shape": f"T={t} train-step ids into ({v}, {d}) bf16 from float32 dout"}
    out["embedding_gather_bwd_bf16"] = brec
    mask = gather_k.clamp_ids(ids, v) < rows
    owned = int(mask.sum())
    sbrec = {"ms": time_ms(torch, lambda: gather_k.embedding_gather_shard_bwd(
                 dout, ids, 0, rows, v, dtype=bf16), flush),
             "bf16_dout_ms": time_ms(torch, lambda: gather_k.embedding_gather_shard_bwd(
                 doutb, ids, 0, rows, v), flush),
             "fp32_ms": time_ms(torch, lambda: gather_k.embedding_gather_shard_bwd(
                 dout, ids, 0, rows, v), flush),
             "plain_ms": time_ms(torch, lambda: gather_k.embedding_gather_shard_bwd_ref(
                 dout, ids, 0, rows, v, dtype=bf16), flush, runs=3, warmup=1),
             "library_ms": time_ms(torch, lambda: torch.zeros(
                 (rows, d), dtype=torch.float32, device=DEVICE).index_add_(
                 0, ids[mask], dout[mask]).to(bf16), flush),
             "bound_ms": (rows * d * 2 + owned * d * 4 + 8 * t)
             / HBM_BYTES_PER_S * 1e3,
             "bf16_dout_bound_ms": ((rows + owned) * d * 2 + 8 * t)
             / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes",
             "shape": f"T={t} train-step ids into shard 0 ({rows}, {d}) bf16 of "
                      f"({v}, {d}) from float32 dout, {owned} owned"}
    out["embedding_gather_shard_bwd_bf16"] = sbrec
    for name, r in (("B9 backward", brec), ("B9 shard backward", sbrec)):
        phase("timing", f"{name} bf16 {r['shape']}: {r['ms']:.4f} ms (fp32 form "
              f"{r['fp32_ms']:.4f} ms) | bound {r['bound_ms']:.4f} ms (bytes) | "
              f"plain {r['plain_ms']:.4f} ms | zeros + index_add_ + .to(bf16) "
              f"{r['library_ms']:.4f} ms; from bf16 dout (no path runs it) "
              f"{r['bf16_dout_ms']:.4f} ms, bound {r['bf16_dout_bound_ms']:.4f} ms")
    del t32, table, dout, doutb
    return out


#: The kernels line's bf16 records: name -> (source, the TPU kernel it
#: replaces or the backward it is)
BF16_RECORDS = {
    "ssd_fused_bf16": ("src/repro_torch/csrc/ssd_fused.cu",
                       "src/repro/kernels/ssd.py:26 (bf16 xd / B / C)"),
    "ssd_fused_bwd_bf16": ("src/repro_torch/csrc/ssd_bwd.cu",
                           "src/repro/kernels/ssd.py:78 (its backward, bf16; the "
                           "reference differentiates src/repro/models/ssm.py:81)"),
    "embedding_gather_bf16": ("src/repro_torch/csrc/embedding_gather.cu",
                              "src/repro/kernels/gather.py:24 (a bf16 table)"),
    "embedding_gather_shard_bf16": ("src/repro_torch/csrc/embedding_gather.cu",
                                    "src/repro/kernels/gather.py:24 (a bf16 "
                                    "table's vocab shard)"),
    "embedding_gather_bwd_bf16": ("src/repro_torch/csrc/embedding_gather.cu",
                                  "src/repro/kernels/gather.py:44 (its backward "
                                  "into a bf16 table; the reference "
                                  "differentiates XLA's gather, "
                                  "src/repro/models/model.py:118)"),
    "embedding_gather_shard_bwd_bf16": ("src/repro_torch/csrc/embedding_gather.cu",
                                        "src/repro/kernels/gather.py:44 (its "
                                        "backward into a bf16 table's shard)"),
}


def run_bf16(torch, np, configs, M, serve, ssm_mod, sharding, make_mesh, ssd_k,
             gather_k, flush) -> list[dict]:
    """Phase 18: the bf16 forms against their contracts, the paths that run
    them (the served bf16 model, the bf16 train step and its checks, the
    (1, 4) mesh step), each form timed; returns the kernels line's bf16
    records, each with its launches on the phase's paths."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg, hybrid = lm_config(configs), lm_family_config(configs, LM_FAMILY_ARCHS[0])
    errs = {"ssd_fused_bf16": compare_bf16_ssd(torch, np, ssd_k, cfg, hybrid),
            "ssd_fused_bwd_bf16": compare_bf16_ssd_bwd(
                torch, np, ssd_k, train_config(configs), hybrid)}
    errs.update(compare_bf16_gather(torch, np, gather_k, cfg))
    phase("bf16", f"kernel checks done in {time.perf_counter() - t0:.1f} s")
    try:
        ssm_mod.SSD_BF16 = True
        sv = bf16_serve(torch, np, configs, M, serve, ssd_k, gather_k)
        tr = bf16_train(torch, np, configs, ssd_k, gather_k)
        ck = bf16_train_check(torch, np, M, ssm_mod, sharding, make_mesh, ssd_k,
                              gather_k, train_config(configs))
    finally:
        ssm_mod.SSD_BF16 = False
    times = time_bf16(torch, np, ssd_k, gather_k, cfg, flush)
    launches = {
        "ssd_fused_bf16": sv["launches"]["ssd_fused"] + tr["launches"]["ssd_fused"],
        "ssd_fused_bwd_bf16": tr["launches"]["ssd_fused_bwd"],
        "embedding_gather_bf16": (sv["launches"]["embedding_gather"]
                                  + tr["launches"]["embedding_gather"]),
        "embedding_gather_shard_bf16": ck["launches"]["embedding_gather_shard"],
        "embedding_gather_bwd_bf16": tr["launches"]["embedding_gather_bwd"],
        "embedding_gather_shard_bwd_bf16": ck["launches"]["embedding_gather_shard_bwd"],
    }
    records = []
    for name, (source, replaces) in BF16_RECORDS.items():
        if not launches[name]:
            raise AssertionError(f"bf16: {name} was not launched on its path")
        records.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], **times[name]})
    phase("bf16", f"served {sv['tokens_per_s']:.2f} tokens/s (prefill "
          f"{sv['prefill_ms']:.2f} ms, decode {sv['decode_ms']:.2f} ms), trained "
          f"{tr['tokens_per_s']:.1f} tokens/s (peak {tr['peak_gb']:.2f} GB); "
          f"launches {launches}; phase {time.perf_counter() - t0:.1f} s")
    return records


# ---------------------------------------------------------------------------
# Phase 19: the reference's attention and placement flags
# ---------------------------------------------------------------------------

#: (a): the dense LM's key block, its logits against the flag-off run (x
#: max|logit|: the online softmax's float32 rounding)
FLAGS_DENSE_CHUNK = 128
FLAGS_CHUNK_RTOL = 1e-5
#: (b): bf16 scores' logits against the bf16 run without them and the
#: card's against the CPU's under the flag (x max|logit|).  bf16
#: activations round every product and sum to 8 bits: without the flag
#: the 2-layer cut's card and CPU logits already part by ~1e-2 x
#: max|logit| (printed beside), the reference's comment puts the flag's
#: own error at ~1e-2 relative on the weights a layer, and the flag moved
#: llama-3.2-3b's logits 1.3e-2 (2 layers) to 2.0e-2 (28) on an H100
FLAGS_BF16_RTOL = 5e-2
#: (c): hymba's key block, its greedy tokens after the long prefill
FLAGS_HYMBA_CHUNK = 256
FLAGS_HYMBA_STEPS = 4
#: (d): (arch, flags) served on FLAGS_MESH naming the card four times
FLAGS_MESH = (1, 4)
FLAGS_MESH_RUNS = (("hymba-1.5b", {"SEQ_SHARD_FALLBACK": True,
                                   "KV_SEQ_SHARD": True}),
                   ("qwen2-1.5b", {"KV_SEQ_SHARD": True}))
#: (e): the FSDP_PARAMS mesh, its train check's steps
FLAGS_FSDP_MESH = (2, 2)
FLAGS_TRAIN_STEPS = 2


@contextlib.contextmanager
def flags_set(attn_mod, specs_mod, **flags):
    """The named flags set as the port's module attributes
    (``models.attention``: ``ATTN_KV_CHUNK``, ``ATTN_BF16_SCORES``,
    ``SEQ_SHARD_FALLBACK``; ``launch.specs``: ``KV_SEQ_SHARD``,
    ``FSDP_PARAMS``), each restored in a ``finally``."""
    mods = {n: attn_mod for n in ("ATTN_KV_CHUNK", "ATTN_BF16_SCORES",
                                  "SEQ_SHARD_FALLBACK")}
    mods.update({n: specs_mod for n in ("KV_SEQ_SHARD", "FSDP_PARAMS")})
    old = {n: getattr(mods[n], n) for n in flags}
    try:
        for n, v in flags.items():
            setattr(mods[n], n, v)
        yield
    finally:
        for n, v in old.items():
            setattr(mods[n], n, v)


def zero_lm_counts(ssd_k, gather_k) -> None:
    for k in ("KERNEL_LAUNCHES", "BWD_LAUNCHES"):
        setattr(ssd_k, k, 0)
    for k in ("KERNEL_LAUNCHES", "SHARD_LAUNCHES", "BWD_LAUNCHES",
              "SHARD_BWD_LAUNCHES"):
        setattr(gather_k, k, 0)


def add_counts(total: dict, ran: dict) -> None:
    for k, n in ran.items():
        total[k] = total.get(k, 0) + n


def steps_err(np, got: dict, want: dict) -> float:
    """The largest difference of two greedy runs' step logits, row by row
    while the tokens fed so far agree."""
    worst = 0.0
    for r in range(want["tokens"].shape[0]):
        for c in range(want["tokens"].shape[1]):
            worst = max(worst, float(np.abs(got["steps"][r, c]
                                            - want["steps"][r, c]).max()))
            if got["tokens"][r, c] != want["tokens"][r, c]:
                break
    return worst


def flags_dense(torch, np, configs, M, serve, attn_mod, specs_mod, ssd_k,
                gather_k, launches: dict) -> dict:
    """Phase 19 (a) and (b): llama-3.2-3b at full width and depth from
    LM_SEED on one card, with and without ``ATTN_KV_CHUNK``: a (LM_SLOTS,
    LM_PROMPT) prefill and MESH_DECODE_STEPS decode steps (prefill ms and
    the peak memory above the weights, the run at its shapes timed after
    one untimed) and LM_SLOTS requests of LM_PROMPT + LM_NEW_TOKENS through
    ``Batcher(n_slots=LM_SLOTS)``; then bf16 activations with and without
    ``ATTN_BF16_SCORES`` (the prefill and decode steps fed the flag-off
    tokens; their difference printed) and :func:`bf16_scores_cut`."""
    cfg = lm_dense_config(configs)
    gc.collect()
    torch.cuda.empty_cache()
    params = M.init_params(M.make_generator(LM_SEED, DEVICE), cfg)
    prompts = np.random.default_rng(LM_SEED + 19).integers(
        0, cfg.vocab_size, (LM_SLOTS, LM_PROMPT)).astype(np.int32)
    runs = {}
    for chunk in (0, FLAGS_DENSE_CHUNK):
        with flags_set(attn_mod, specs_mod, ATTN_KV_CHUNK=chunk):
            greedy_steps(torch, np, M, params, cfg, prompts, 1)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            zero_lm_counts(ssd_k, gather_k)
            got = greedy_steps(torch, np, M, params, cfg, prompts,
                               LM_NEW_TOKENS, keep_prefill=True)
            got["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
            b = timed_batcher(torch, serve)(
                cfg, params, n_slots=LM_SLOTS,
                gcfg=serve.GenerationConfig(cache_len=LM_PROMPT + LM_NEW_TOKENS))
            for rid in range(LM_SLOTS):
                b.submit(serve.Request(rid=rid, prompt=prompts[rid],
                                       max_new_tokens=LM_NEW_TOKENS))
            got["batcher"] = {r.rid: r.generated for r in b.run()}
            torch.cuda.synchronize()
            got["batcher_prefill_ms"] = 1e3 * statistics.median(b.prefill_s)
            got["launches"] = all_lm_counts(ssd_k, gather_k)
            add_counts(launches, got["launches"])
            runs[chunk] = got
    off, on = runs[0], runs[FLAGS_DENSE_CHUNK]
    scale = max(1.0, float(off["prefill"].abs().max()))
    tol = FLAGS_CHUNK_RTOL * scale
    pre_err = max_err(on["prefill"], off["prefill"])
    step_err = steps_err(np, on, off)
    if not (pre_err <= tol and step_err <= tol):
        raise AssertionError(f"flags (a): ATTN_KV_CHUNK logits differ by "
                             f"{pre_err:.3e} / {step_err:.3e} > {tol:.3e}")
    margin_rule(on["tokens"], off["tokens"], off["margins"], tol,
                label="flags (a) greedy")
    for rid in range(LM_SLOTS):
        for run, what in ((on, "flag on"), (off, "flag off")):
            margin_rule(np.asarray([run["batcher"][rid]]),
                        off["tokens"][rid:rid + 1], off["margins"][rid:rid + 1],
                        tol, label=f"flags (a) batcher {what} {rid}")
    if on["launches"]["embedding_gather"] == 0:
        raise AssertionError(f"flags (a): launches {on['launches']}")
    phase("flags", f"(a) {cfg.name} ({cfg.n_layers} layers) ATTN_KV_CHUNK="
          f"{FLAGS_DENSE_CHUNK}: ({LM_SLOTS}, {LM_PROMPT}) prefill "
          f"{on['prefill_ms']:.2f} ms, peak {on['peak_gb']:.3f} GB above the "
          f"weights (flag off {off['prefill_ms']:.2f} ms, {off['peak_gb']:.3f} "
          f"GB); b = 1 batcher prefill {on['batcher_prefill_ms']:.2f} ms "
          f"(off {off['batcher_prefill_ms']:.2f}); decode {on['decode_ms']:.2f} "
          f"ms a step (off {off['decode_ms']:.2f}); logits within "
          f"{pre_err:.3e} / {step_err:.3e} (limit {tol:.3e}); batcher tokens "
          f"equal past the margin ({LM_SLOTS} x {LM_NEW_TOKENS}, both ways); launches {on['launches']} | "
          f"{smi_line()}")
    bf = {}
    for flag in (False, True):
        with flags_set(attn_mod, specs_mod, ATTN_BF16_SCORES=flag), torch.no_grad():
            zero_lm_counts(ssd_k, gather_k)
            caches = M.init_caches(cfg, LM_SLOTS, LM_PROMPT + LM_NEW_TOKENS,
                                   dtype=torch.bfloat16, device=DEVICE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = M.prefill(params, cfg, {"tokens": prompts}, caches,
                                       dtype=torch.bfloat16)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            outs = [logits.float().cpu()]
            feed = (torch.argmax(logits[:, -1], -1) if not flag
                    else bf[False]["fed"][0])
            fed = [feed]
            for i in range(MESH_DECODE_STEPS):
                last, caches = M.decode_step(params, cfg, feed[:, None], caches,
                                             dtype=torch.bfloat16)
                outs.append(last.float().cpu())
                feed = (torch.argmax(last, -1) if not flag
                        else bf[False]["fed"][i + 1])
                fed.append(feed)
            bf[flag] = {"logits": outs, "fed": fed, "ms": ms,
                        "launches": all_lm_counts(ssd_k, gather_k)}
            add_counts(launches, bf[flag]["launches"])
            del logits, caches
    scale = max(1.0, float(bf[False]["logits"][0].abs().max()))
    errs = [max_err(a, b) for a, b in zip(bf[True]["logits"], bf[False]["logits"])]
    if max(errs) > FLAGS_BF16_RTOL * scale:
        raise AssertionError(f"flags (b): ATTN_BF16_SCORES moves the logits "
                             f"{max(errs) / scale:.3e} x max|logit| > "
                             f"{FLAGS_BF16_RTOL}")
    cut = bf16_scores_cut(torch, np, M, attn_mod, specs_mod, params, cfg,
                          prompts[:1])
    phase("flags", f"(b) {cfg.name} bf16 activations, ATTN_BF16_SCORES: "
          f"({LM_SLOTS}, {LM_PROMPT}) prefill {bf[True]['ms']:.2f} ms (off "
          f"{bf[False]['ms']:.2f}); at {cfg.n_layers} layers the logits move "
          f"{errs[0] / scale:.3e} (prefill) / {max(errs[1:]) / scale:.3e} "
          f"(decode) x max|logit| from the bf16 run without it; the "
          f"{LM_CHECK_LAYERS}-layer full-width cut: flag on against off "
          f"{cut['on_off']:.3e}, card against the CPU under the flag "
          f"{cut['card_cpu']:.3e} (without it {cut['floor']:.3e}) x "
          f"max|logit| (limit {FLAGS_BF16_RTOL}); "
          f"launches {bf[True]['launches']} | {smi_line()}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"chunk": {k: {x: v[x] for x in ("prefill_ms", "peak_gb", "decode_ms",
                                            "batcher_prefill_ms")}
                      for k, v in runs.items()},
            "chunk_err": max(pre_err, step_err) / scale,
            "bf16_err": max(errs) / scale, "bf16_cut": cut}


def bf16_scores_cut(torch, np, M, attn_mod, specs_mod, params, cfg,
                    prompt) -> dict:
    """Phase 19 (b)'s cut: the first LM_CHECK_LAYERS layers of ``params`` at
    full width (:func:`check_model`), ``prompt``'s bf16 prefill logits with
    and without ``ATTN_BF16_SCORES`` on the card and on the CPU (a copy
    made tensor by tensor): the flag's effect on the card (``on_off``),
    the card against the CPU under it (``card_cpu``) and without it
    (``floor``: bf16 activations' own spread), x max|logit|; the first two
    within FLAGS_BF16_RTOL."""
    import copy

    from torch import nn

    card, cfg2 = check_model(M, nn, params, cfg)
    host = copy.deepcopy(card, memo={
        id(t): nn.Parameter(t.detach().cpu(), requires_grad=False)
        for t in card.parameters()})
    got = {}
    with torch.no_grad():
        for (dev, flag), p in (((DEVICE, True), card), ((DEVICE, False), card),
                               (("cpu", True), host), (("cpu", False), host)):
            with flags_set(attn_mod, specs_mod, ATTN_BF16_SCORES=flag):
                caches = M.init_caches(cfg2, 1, prompt.shape[1],
                                       dtype=torch.bfloat16, device=dev)
                logits, _ = M.prefill(p, cfg2, {"tokens": prompt}, caches,
                                      dtype=torch.bfloat16)
                got[dev, flag] = logits.float().cpu()
    scale = max(1.0, float(got["cpu", False].abs().max()))
    out = {"on_off": max_err(got[DEVICE, True], got[DEVICE, False]) / scale,
           "card_cpu": max_err(got[DEVICE, True], got["cpu", True]) / scale,
           "floor": max_err(got[DEVICE, False], got["cpu", False]) / scale}
    if max(out["on_off"], out["card_cpu"]) > FLAGS_BF16_RTOL:
        raise AssertionError(f"flags (b): the {cfg2.n_layers}-layer cut's bf16 "
                             f"logits {out} x max|logit| > {FLAGS_BF16_RTOL}")
    return out


def flags_hymba_long(torch, np, configs, M, attn_mod, specs_mod, ssd_k,
                     gather_k, launches: dict) -> dict:
    """Phase 19 (c): hymba-1.5b at full width and depth from LM_SEED, one
    LM_HYMBA_LONG-token prompt (past its 2048-slot ring) prefilled under
    ``ATTN_KV_CHUNK`` = FLAGS_HYMBA_CHUNK and FLAGS_HYMBA_STEPS - 1 greedy
    decode steps; their logits against the flag-off forward without a
    cache over the prompt and the tokens fed (padded to a chunk multiple:
    B8's path; causal, so the padding changes no position checked), at
    LM_LOGIT_RTOL x max|logit|.  The flag-off prefill beside it: its
    queries before the last lose part of their window to the ring
    (reference behaviour), the difference printed."""
    cfg = lm_family_config(configs, "hymba-1.5b")
    gc.collect()
    torch.cuda.empty_cache()
    params = M.init_params(M.make_generator(LM_SEED, DEVICE), cfg)
    s = LM_HYMBA_LONG
    prompt = np.random.default_rng(LM_SEED + 20).integers(
        0, cfg.vocab_size, (1, s)).astype(np.int32)
    run = {}
    with torch.no_grad():
        for chunk in (FLAGS_HYMBA_CHUNK, 0):
            with flags_set(attn_mod, specs_mod, ATTN_KV_CHUNK=chunk):
                zero_lm_counts(ssd_k, gather_k)
                caches = M.init_caches(cfg, 1, s + FLAGS_HYMBA_STEPS,
                                       dtype=torch.float32, device=DEVICE)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                logits, caches = M.prefill(params, cfg, {"tokens": prompt}, caches)
                torch.cuda.synchronize()
                r = {"ms": (time.perf_counter() - t0) * 1e3,
                     "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                     "prefill": logits.cpu()}
                last, toks, steps = logits[:, -1], [], []
                for i in range(FLAGS_HYMBA_STEPS):
                    toks.append(int(torch.argmax(last[0])))
                    if i + 1 < FLAGS_HYMBA_STEPS:
                        last, caches = M.decode_step(
                            params, cfg, torch.tensor([[toks[-1]]], device=DEVICE),
                            caches)
                        steps.append(last[0].cpu())
                r.update(tokens=toks, steps=steps,
                         launches=all_lm_counts(ssd_k, gather_k))
                add_counts(launches, r["launches"])
                run[chunk] = r
                del logits, caches, last
        on, off = run[FLAGS_HYMBA_CHUNK], run[0]
        zero_lm_counts(ssd_k, gather_k)
        n = s + FLAGS_HYMBA_STEPS - 1
        n = -(-n // FLAGS_HYMBA_CHUNK) * FLAGS_HYMBA_CHUNK
        seq = np.zeros((1, n), np.int32)
        seq[0, :s] = prompt[0]
        seq[0, s:s + FLAGS_HYMBA_STEPS - 1] = on["tokens"][:-1]
        whole, _ = M.forward(params, cfg, {"tokens": seq})
        add_counts(launches, all_lm_counts(ssd_k, gather_k))
        oracle = whole[0, :s + FLAGS_HYMBA_STEPS - 1].cpu()
        del whole
    scale = max(1.0, float(oracle.abs().max()))
    tol = LM_LOGIT_RTOL * scale
    pre_err = max_err(on["prefill"][0], oracle[:s])
    step_err = max((max_err(g, oracle[s - 1 + j + 1])
                    for j, g in enumerate(on["steps"])), default=0.0)
    if not (pre_err <= tol and step_err <= tol):
        raise AssertionError(f"flags (c): hymba's chunked prefill differs from "
                             f"the forward by {pre_err:.3e} / {step_err:.3e} > "
                             f"{tol:.3e}")
    top2 = np.sort(oracle[s - 1:].numpy(), axis=-1)[:, -2:]
    margin_rule(np.asarray([on["tokens"]]), oracle[s - 1:].numpy().argmax(-1)[None],
                (top2[:, 1] - top2[:, 0])[None], tol, label="flags (c) tokens")
    off_err = max_err(off["prefill"][0, :s - 1], oracle[:s - 1])
    if on["launches"]["ssd_fused"] == 0 or on["launches"]["embedding_gather"] == 0:
        raise AssertionError(f"flags (c): launches {on['launches']}")
    phase("flags", f"(c) {cfg.name} ({cfg.n_layers} layers) {s}-token prefill, "
          f"ATTN_KV_CHUNK={FLAGS_HYMBA_CHUNK}: {on['ms']:.2f} ms, peak "
          f"{on['peak_gb']:.3f} GB above the weights (flag off {off['ms']:.2f} "
          f"ms, {off['peak_gb']:.3f} GB); against the flag-off forward over "
          f"{n} tokens: prefill {pre_err:.3e}, {FLAGS_HYMBA_STEPS - 1} decode "
          f"steps {step_err:.3e} (limit {tol:.3e}), tokens {on['tokens']} "
          f"(flag off {off['tokens']}); the flag-off prefill's earlier "
          f"positions differ from the forward by {off_err:.3e} (its ring's "
          f"evicted keys); launches {on['launches']} | {smi_line()}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"on": {k: on[k] for k in ("ms", "peak_gb")},
            "off": {k: off[k] for k in ("ms", "peak_gb")},
            "err": max(pre_err, step_err) / scale, "off_err": off_err / scale}


def kv_bytes(placed_caches, coord) -> int:
    """The bytes of the k / v pieces the device at ``coord`` holds."""
    kv = placed_caches["layers"].kv
    return sum(leaf.pieces[coord].numel() * leaf.pieces[coord].element_size()
               for leaf in (kv.k, kv.v))


def flags_mesh(torch, np, configs, M, make_mesh, attn_mod, specs_mod, ssd_k,
               gather_k, launches: dict) -> list[dict]:
    """Phase 19 (d): each of FLAGS_MESH_RUNS at full width and depth from
    LM_SEED: unsharded, then born sharded on FLAGS_MESH naming the card
    four times under its flags (a (LM_SLOTS, LM_PROMPT) prefill and
    MESH_DECODE_STEPS steps, timed after an untimed run at its shapes),
    logits within MESH_LOGIT_RTOL x max|logit| of the unsharded run,
    tokens equal past that margin; the k / v bytes a device at the run's
    cache length and at hymba's ring of 2048."""
    out = []
    n_dev = FLAGS_MESH[0] * FLAGS_MESH[1]
    mesh = make_mesh(FLAGS_MESH, ("data", "model"), (MESH_DEVICE,) * n_dev)
    for arch, flags in FLAGS_MESH_RUNS:
        cfg = configs.get_config(arch)
        prompts = np.random.default_rng(LM_SEED + 21).integers(
            0, cfg.vocab_size, (LM_SLOTS, LM_PROMPT)).astype(np.int32)
        gc.collect()
        torch.cuda.empty_cache()
        params = M.init_params(M.make_generator(LM_SEED, DEVICE), cfg)
        greedy_steps(torch, np, M, params, cfg, prompts, 2)
        want = greedy_steps(torch, np, M, params, cfg, prompts,
                            MESH_DECODE_STEPS + 1, keep_prefill=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        with flags_set(attn_mod, specs_mod, **flags):
            placed = M.init_params(M.make_generator(LM_SEED, DEVICE), cfg,
                                   mesh=mesh)
            zero_lm_counts(ssd_k, gather_k)
            greedy_steps(torch, np, M, placed, cfg, prompts, 2, mesh=mesh)
            got = greedy_steps(torch, np, M, placed, cfg, prompts,
                               MESH_DECODE_STEPS + 1, mesh=mesh, keep_prefill=True)
            torch.cuda.synchronize()
            ran = all_lm_counts(ssd_k, gather_k)
            add_counts(launches, ran)
            sizes = {}
            for cache_len in (LM_PROMPT + LM_NEW_TOKENS, 2048):
                c = M.init_caches(cfg, LM_SLOTS, cache_len, dtype=torch.float32,
                                  device=DEVICE, mesh=mesh)
                sizes[cache_len] = kv_bytes(c, (0, 0))
                whole = M.init_caches(cfg, LM_SLOTS, cache_len,
                                      dtype=torch.float32, device=DEVICE)
                sizes[f"whole{cache_len}"] = sum(
                    t.numel() * t.element_size()
                    for t in (whole["layers"].kv.k, whole["layers"].kv.v))
                del c, whole
        scale = max(1.0, float(want["prefill"].abs().max()),
                    float(np.abs(want["steps"]).max()))
        tol = MESH_LOGIT_RTOL * scale
        pre_err = max_err(got["prefill"], want["prefill"])
        step_err = steps_err(np, got, want)
        if not (pre_err <= tol and step_err <= tol):
            raise AssertionError(f"flags (d) {arch}: logits differ by "
                                 f"{pre_err:.3e} / {step_err:.3e} > {tol:.3e}")
        checked, close = margin_rule(got["tokens"], want["tokens"],
                                     want["margins"], tol,
                                     label=f"flags (d) {arch}")
        b9 = ran["embedding_gather"] + ran["embedding_gather_shard"]
        if b9 == 0 or (cfg.ssm is not None and ran["ssd_fused"] == 0):
            raise AssertionError(f"flags (d) {arch}: launches {ran}")
        cl = LM_PROMPT + LM_NEW_TOKENS
        rec = {"arch": arch, "flags": sorted(flags), "mesh": list(FLAGS_MESH),
               "prefill_ms": got["prefill_ms"], "decode_ms": got["decode_ms"],
               "unsharded": {"prefill_ms": want["prefill_ms"],
                             "decode_ms": want["decode_ms"]},
               "kv_bytes_a_device": sizes[cl], "kv_bytes_whole": sizes[f"whole{cl}"],
               "kv_bytes_a_device_2048": sizes[2048],
               "kv_bytes_whole_2048": sizes["whole2048"],
               "err": max(pre_err, step_err) / scale, "launches": ran}
        out.append(rec)
        phase("flags", f"(d) {cfg.name} ({cfg.n_layers} layers, {cfg.n_heads} q "
              f"/ {cfg.n_kv_heads} kv heads) on {FLAGS_MESH} over {MESH_DEVICE} "
              f"x {n_dev}, {' + '.join(sorted(flags))}: prefill ({LM_SLOTS}, "
              f"{LM_PROMPT}) {got['prefill_ms']:.2f} ms, decode "
              f"{got['decode_ms']:.2f} ms a step (unsharded "
              f"{want['prefill_ms']:.2f} / {want['decode_ms']:.2f}); k / v "
              f"{sizes[cl] / 1e9:.4f} GB a device of {sizes[f'whole{cl}'] / 1e9:.4f} "
              f"GB at cache length {cl}, {sizes[2048] / 1e9:.4f} of "
              f"{sizes['whole2048'] / 1e9:.4f} GB at 2048; logits within "
              f"{pre_err:.3e} / {step_err:.3e} (limit {tol:.3e}); "
              f"{len(checked)} greedy tokens equal, {len(close)} within the "
              f"margin; launches {ran} | {smi_line()}")
        del placed
        gc.collect()
        torch.cuda.empty_cache()
    return out


def placed_bytes(placed) -> int:
    return sum(t.numel() * t.element_size() for _, leaf in placed.items()
               for t in leaf.pieces.flat)


def flags_fsdp(torch, np, configs, M, make_mesh, attn_mod, specs_mod, ssd_k,
               gather_k, launches: dict) -> dict:
    """Phase 19 (e): llama-3.2-3b at full width and depth born sharded from
    LM_SEED on FLAGS_FSDP_MESH (naming the card four times) with and
    without ``FSDP_PARAMS``: a (LM_SLOTS, LM_PROMPT) prefill and
    MESH_DECODE_STEPS steps, logits ``torch.equal``, the resident
    parameter bytes both ways; then FLAGS_TRAIN_STEPS steps of its 2-layer
    cut (remat TRAIN_REMAT) on the same mesh both ways, losses and updated
    parameters ``torch.equal``."""
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = lm_dense_config(configs)
    n_dev = FLAGS_FSDP_MESH[0] * FLAGS_FSDP_MESH[1]
    mesh = make_mesh(FLAGS_FSDP_MESH, ("data", "model"), (MESH_DEVICE,) * n_dev)
    prompts = np.random.default_rng(LM_SEED + 22).integers(
        0, cfg.vocab_size, (LM_SLOTS, LM_PROMPT)).astype(np.int32)
    serve_runs, train_runs = {}, {}
    cut = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS)
    rng = np.random.default_rng(LM_SEED + 23)
    batches = [{k: rng.integers(0, cut.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)
                                ).astype(np.int32) for k in ("tokens", "labels")}
               for _ in range(FLAGS_TRAIN_STEPS)]
    for flag in (False, True):
        with flags_set(attn_mod, specs_mod, FSDP_PARAMS=flag):
            gc.collect()
            torch.cuda.empty_cache()
            placed = M.init_params(M.make_generator(LM_SEED, DEVICE), cfg, mesh=mesh)
            nbytes = placed_bytes(placed)
            zero_lm_counts(ssd_k, gather_k)
            greedy_steps(torch, np, M, placed, cfg, prompts, 2, mesh=mesh)
            got = greedy_steps(torch, np, M, placed, cfg, prompts,
                               MESH_DECODE_STEPS + 1, mesh=mesh, keep_prefill=True)
            torch.cuda.synchronize()
            got["launches"] = all_lm_counts(ssd_k, gather_k)
            add_counts(launches, got["launches"])
            got["bytes"] = nbytes
            serve_runs[flag] = got
            del placed
            gc.collect()
            torch.cuda.empty_cache()
            tcfg = TrainConfig(remat=TRAIN_REMAT)
            state = init_train_state(M.make_generator(LM_SEED, DEVICE), cut, tcfg,
                                     mesh=mesh)
            step = make_train_step(cut, tcfg)
            zero_lm_counts(ssd_k, gather_k)
            losses, ms = [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            ran = all_lm_counts(ssd_k, gather_k)
            add_counts(launches, ran)
            with torch.no_grad():
                kept = {k: leaf.full("cpu") for k, leaf in state.params.items()}
            train_runs[flag] = {"losses": losses, "ms": ms, "launches": ran,
                                "bytes": placed_bytes(state.params),
                                "params": kept}
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
    off, on = serve_runs[False], serve_runs[True]
    if not (torch.equal(on["prefill"], off["prefill"])
            and np.array_equal(on["steps"], off["steps"])):
        raise AssertionError(f"flags (e): FSDP_PARAMS logits differ by "
                             f"{max_err(on['prefill'], off['prefill']):.3e}")
    t_off, t_on = train_runs[False], train_runs[True]
    unequal = [k for k, p in t_on["params"].items()
               if not torch.equal(p, t_off["params"][k])]
    if t_on["losses"] != t_off["losses"] or unequal:
        raise AssertionError(f"flags (e): FSDP_PARAMS train losses "
                             f"{t_on['losses']} against {t_off['losses']}; "
                             f"parameters unequal: {unequal[:8]}")
    if on["launches"]["embedding_gather_shard"] == 0 or \
            t_on["launches"]["embedding_gather_shard_bwd"] == 0:
        raise AssertionError(f"flags (e): launches {on['launches']} / "
                             f"{t_on['launches']}")
    phase("flags", f"(e) {cfg.name} ({cfg.n_layers} layers) on {FLAGS_FSDP_MESH} "
          f"over {MESH_DEVICE} x {n_dev}: resident parameters "
          f"{on['bytes'] / 1e9:.3f} GB summed over the devices with FSDP_PARAMS, "
          f"{off['bytes'] / 1e9:.3f} GB without; prefill {on['prefill_ms']:.2f} "
          f"ms, decode {on['decode_ms']:.2f} ms a step (without "
          f"{off['prefill_ms']:.2f} / {off['decode_ms']:.2f}); logits "
          f"torch.equal; {cut.n_layers}-layer cut, {FLAGS_TRAIN_STEPS} steps of "
          f"({TRAIN_BATCH}, {TRAIN_SEQ}): losses {t_on['losses']} both ways, "
          f"every updated parameter torch.equal, "
          f"{t_on['bytes'] / 1e9:.3f} / {t_off['bytes'] / 1e9:.3f} GB of "
          f"parameters, step ms {[round(x, 1) for x in t_on['ms']]} (without "
          f"{[round(x, 1) for x in t_off['ms']]}); launches {on['launches']} "
          f"/ {t_on['launches']} | {smi_line()}")
    return {"bytes": {"fsdp": on["bytes"], "plain": off["bytes"]},
            "prefill_ms": {"fsdp": on["prefill_ms"], "plain": off["prefill_ms"]},
            "decode_ms": {"fsdp": on["decode_ms"], "plain": off["decode_ms"]},
            "train_ms": {"fsdp": t_on["ms"], "plain": t_off["ms"]},
            "losses": t_on["losses"]}


def run_flags(torch, np, configs, M, serve, make_mesh, attn_mod, specs_mod,
              ssd_k, gather_k) -> dict:
    """Phase 19: checks (a)-(e) of the flags; returns their readings and
    the phase's launches of B8 and B9 (every form) by kernel name."""
    t0 = time.perf_counter()
    launches: dict = {}
    out = {"dense": flags_dense(torch, np, configs, M, serve, attn_mod,
                                specs_mod, ssd_k, gather_k, launches)}
    out["hymba"] = flags_hymba_long(torch, np, configs, M, attn_mod, specs_mod,
                                    ssd_k, gather_k, launches)
    out["mesh"] = flags_mesh(torch, np, configs, M, make_mesh, attn_mod,
                             specs_mod, ssd_k, gather_k, launches)
    out["fsdp"] = flags_fsdp(torch, np, configs, M, make_mesh, attn_mod,
                             specs_mod, ssd_k, gather_k, launches)
    out["launches"] = {k: n for k, n in launches.items() if n}
    phase("flags", f"launches {out['launches']}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def add_flags(kernels: list[dict], fl: dict) -> None:
    """Phase 19 on the kernels line: its launches of B8 and B9 (each form)
    under ``launches_by_path["flags"]``."""
    for name, n in fl["launches"].items():
        rec = next(r for r in kernels if r["name"] == name)
        rec.setdefault("launches_by_path", {"earlier phases": rec["launches"]})
        rec["launches_by_path"]["flags"] = n
        rec["launches"] += n


def add_mesh_families(kernels: list[dict], mf: dict) -> None:
    """Phase 17 on the kernels line: its launches of B8, B9 (whole table
    and shard form) and their backward kernels under
    ``launches_by_path["mesh-families"]``."""
    for name, n in mf["launches"].items():
        rec = next(r for r in kernels if r["name"] == name)
        rec.setdefault("launches_by_path", {"earlier phases": rec["launches"]})
        rec["launches_by_path"]["mesh-families"] = n
        rec["launches"] += n


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    # fp32 products in full fp32, as the CPU computes them (the LM check)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import configs, serve
    from repro_torch.compat import make_mesh
    from repro_torch.graphs import gen as G
    from repro_torch.kernels import bfs as bfs_k
    from repro_torch.kernels import cuda_lib, ops, sell_core, sell_shard
    from repro_torch.kernels import fft as fft_k
    from repro_torch.kernels import gather as gather_k
    from repro_torch.kernels import pagerank as pr_k
    from repro_torch.kernels import spmv as spmv_k
    from repro_torch.kernels import ssd as ssd_k
    from repro_torch.kernels.execspec import ExecSpec
    from repro_torch.launch import specs as specs_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model as M
    from repro_torch.models import moe, sharding
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.service import KernelRegistry, KernelService
    from repro_torch.sparse import formats as F

    t_start = time.perf_counter()
    # -- 1. device -----------------------------------------------------------
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_lib.build_all()
    for b in built:
        regs = [ln.strip() for ln in b.log.splitlines()
                if "registers" in ln or "spill" in ln]
        phase("build", f"{b.name}: {b.path.name} in {b.seconds:.1f} s")
        for ln in regs:
            phase("build", f"  {ln}")
    phase("build", f"all kernels built in {time.perf_counter() - t0:.1f} s")

    # -- 3. kernels vs plain ---------------------------------------------------
    t0 = time.perf_counter()
    compare_kernel(torch, np, sell_core, F)
    compare_graph_kernels(torch, np, G, bfs_k, pr_k)
    compare_spmv_ell(torch, np, F, spmv_k)
    compare_live_bounds(torch, np, F, G, spmv_k, bfs_k, pr_k)
    compare_fft(torch, np, fft_k)
    compare_stream(torch, np, sell_core, F)
    ssd_errs = compare_ssd(torch, np, ssd_k, lm_config(configs),
                           lm_family_config(configs, LM_FAMILY_ARCHS[0]))
    compare_gather(torch, np, gather_k, lm_config(configs))
    phase("compare", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 4. SpMV main path -----------------------------------------------------
    t0 = time.perf_counter()
    reg, big, spmv_launches = spmv_main_path(
        torch, np, F, sell_core, KernelRegistry, KernelService)
    phase("main", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 5. graph main path ----------------------------------------------------
    t0 = time.perf_counter()
    gm = graph_main_path(torch, np, G, bfs_k, pr_k, ops, ExecSpec,
                         KernelRegistry, KernelService)
    phase("graphs", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 6. FFT main path --------------------------------------------------------
    t0 = time.perf_counter()
    fm = fft_main_path(torch, np, F, fft_k, sell_core, KernelRegistry,
                       KernelService)
    phase("fft", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 7. ELLPACK through ops --------------------------------------------------
    t0 = time.perf_counter()
    em = ellpack_ops_path(torch, np, F, spmv_k, ops, ExecSpec)
    phase("ellpack", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 8. streaming schedule through ops -------------------------------------
    t0 = time.perf_counter()
    sm = stream_path(torch, np, F, sell_core, ops, ExecSpec)
    phase("stream", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 9. MoE dispatch through the service -----------------------------------
    t0 = time.perf_counter()
    mm = moe_path(torch, np, F, sell_core, ops, ExecSpec, KernelRegistry,
                  KernelService)
    phase("moe", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 10. the LM serving path (B8, B9) ---------------------------------------
    t0 = time.perf_counter()
    lm = lm_path(torch, np, configs, M, serve, ssd_k, gather_k)
    lm_check(torch, np, M, lm)
    phase("lm", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 10b. the dense attention LM (B9) ----------------------------------------
    t0 = time.perf_counter()
    dense = lm_path(torch, np, configs, M, serve, ssd_k, gather_k,
                    cfg=lm_dense_config(configs), name="lm-dense")
    lm_check(torch, np, M, dense, label="lm-dense")
    profile_lm(torch, M, dense)
    b9_by_path = {"lm": lm["launches"]["embedding_gather"],
                  "lm-dense": dense["launches"]["embedding_gather"]}
    del dense
    torch.cuda.empty_cache()
    phase("lm-dense", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 11. timing at the main paths' shapes ----------------------------------
    t0 = time.perf_counter()
    flush = torch.empty(2 * 50 * 1000 * 1000 // 4, dtype=torch.float32,
                        device=DEVICE)
    kernels = [time_spmv(torch, np, sell_core, reg.get("big"), big,
                         spmv_launches, flush)]
    kernels += graph_records(gm, time_graphs(torch, np, G, sell_core, bfs_k,
                                             pr_k, gm, flush))
    kernels += time_spmv_ell(torch, np, spmv_k, ops, em, flush)
    kernels += time_fft(torch, np, fft_k, fm, flush)
    kernels.append(stream_record(sm, time_stream(
        torch, np, sell_core, ops, sm, reg.get("big"), big, flush)))
    kernels += time_moe(torch, np, sell_core, mm, flush)
    kernels += time_lm(torch, np, ssd_k, gather_k, lm, ssd_errs["lm"],
                       b9_by_path, flush)
    profile_drives(torch, bfs_k, pr_k, gm)
    profile_lm(torch, M, lm)
    phase("timing", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 11b. the paper's sweep study (B4, B5, B6, B7 at each VL; B1) --------
    t0 = time.perf_counter()
    add_study(kernels, study_path(torch, np, F, G, bfs_k, pr_k, spmv_k, fft_k,
                                  sell_core, KernelRegistry, KernelService))
    phase("study", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 11c. the sharded path (B1, B3 a shard) and float32 PageRank --------
    t0 = time.perf_counter()
    shm = sharded_path(torch, np, sell_core, sell_shard, bfs_k, pr_k, ops,
                       ExecSpec, KernelRegistry, KernelService, reg, big, gm)
    kernels += time_sharded(torch, np, sell_core, sell_shard, pr_k, shm, gm,
                            flush)
    add_sharded(kernels, shm)
    del shm
    ops.reset_default_tune_cache()       # the sharded layouts it holds
    phase("sharded", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 12. the MoE LM (B1 on its combines, B9) -----------------------------
    # deepseek-moe-16b's 67.5 GB need the card to themselves: every earlier
    # phase's operands and models go first
    t0 = time.perf_counter()
    del lm, reg, big, gm, fm, em, sm, mm
    gc.collect()
    torch.cuda.empty_cache()
    records, b9 = run_lm_moe(torch, np, configs, M, serve, moe, sell_core,
                             gather_k, ops, KernelRegistry, KernelService,
                             flush)
    kernels += records
    for rec in kernels:
        if rec["name"] == "embedding_gather":
            rec["launches"] += b9
            rec["launches_by_path"]["lm-moe"] = b9
    torch.cuda.empty_cache()
    phase("lm-moe", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 13. the hybrid, enc-dec and vision LMs (B8 at hymba's widths, B9) --
    # one model on the card at a time: llama-3.2-vision-11b's 47.85 GB
    # after deepseek's are freed
    t0 = time.perf_counter()
    add_families(kernels, lm_families_path(torch, np, configs, M, serve,
                                           ssd_k, gather_k, flush),
                 ssd_errs["hybrid"])
    phase("lm-families", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 14. training (B8 and B9, forward and backward) --------------------
    t0 = time.perf_counter()
    terrs = {"ssd": compare_ssd_bwd(torch, np, ssd_k, train_config(configs),
                                    lm_family_config(configs,
                                                     LM_FAMILY_ARCHS[0])),
             "gather": compare_gather_bwd(torch, np, gather_k,
                                          train_config(configs))}
    train_check(torch, np, M, ssd_k, gather_k, train_config(configs))
    tm = train_path(torch, np, configs, M, ssd_k, gather_k)
    train_resume(torch, configs)
    add_train(kernels, tm)
    kernels += time_train_kernels(torch, np, ssd_k, gather_k, tm, terrs, flush)
    phase("train", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 15. the dense and MoE families over (data, model) meshes ---------
    t0 = time.perf_counter()
    del tm
    gc.collect()
    torch.cuda.empty_cache()
    shard_err = compare_gather_shard(torch, np, gather_k)
    mp = mesh_path(torch, np, configs, M, serve, moe, sell_core, gather_k,
                   KernelRegistry, KernelService, make_mesh, sharding)
    add_mesh(kernels, mp, time_gather_shard(torch, np, gather_k, flush,
                                            mp["b9_shard"], shard_err))
    phase("mesh", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 16. training over a (data, model) mesh, mamba2 on a mesh ---------
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    mt, shard_bwd = run_mesh_train(torch, np, configs, M, serve, ssm_mod,
                                   sharding, make_mesh, ssd_k, gather_k, flush)
    add_mesh_train(kernels, mt, shard_bwd)
    del mt
    phase("mesh-train", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 17. the hybrid, enc-dec and vision families on (data, model) meshes
    t0 = time.perf_counter()
    add_mesh_families(kernels, mesh_families_path(
        torch, np, configs, M, serve, sharding, make_mesh, ssm_mod, ssd_k,
        gather_k))
    phase("mesh-families", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 18. the bf16 forms of B8 and B9 and their paths --------------------
    t0 = time.perf_counter()
    kernels += run_bf16(torch, np, configs, M, serve, ssm_mod, sharding,
                        make_mesh, ssd_k, gather_k, flush)
    phase("bf16", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 19. the reference's attention and placement flags ----------------
    t0 = time.perf_counter()
    add_flags(kernels, run_flags(torch, np, configs, M, serve, make_mesh,
                                 attn_mod, specs_mod, ssd_k, gather_k))
    phase("flags", f"done in {time.perf_counter() - t0:.1f} s; whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
