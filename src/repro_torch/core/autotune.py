"""SELL layout selection on a Hopper budget.

The port's counterpart of ``repro.core.autotune``: the paper's co-design
loop picks the SELL-C-sigma layout (C, sigma) from the *measured* pad
factor of the operand's row lengths.  The reference scores each candidate
with the SDV cycle model; on an H100 a SIMT instruction is one 32-thread
warp whatever C is, so that model saw every warp-multiple C at the same
vector length and ranked layouts by pad factor alone.  The port therefore
ranks by pad factor directly, and brings the cycle model back once the
card's memory latencies are measured (ROADMAP A14).  The reference's
model-driven VL tuner is here too (:func:`tune_vl`), on the port's cycle
model and shared-memory budget; nothing on the serving path calls it.
What else changes on an H100 is the budget the RHS tile is priced against.

The TPU tuner sizes ``k_block`` so that the whole ``(n_cols, k_block)`` X
block fits VMEM (64 MiB, double-buffered); a 2M-column operand fails that
filter at any k > 1 and is tuned to ``k_block = 1``.  On Hopper X is not
staged in fast memory at all: it stays in device memory, its gathers go
through the 50 MB L2, and each CUDA thread keeps its ``k_tile`` partial
sums in registers.  So :func:`pick_k_block` prices the per-thread
accumulators against the register file, never X residency, and coalesced
request groups keep their full RHS width on million-column operands.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.sdv import MachineParams, SDVMachine, Trace, h100_machine
from repro_torch.core.vconfig import VectorConfig
from repro_torch.sparse.formats import (
    next_pow2,
    pow2_ceil,
    shard_row_ranges,
    sigma_sort_order,
    slice_widths,
)

#: Threads per warp: the SIMT group one SELL slice column is walked by.
WARP = 32
#: Threads per block of the SELL SpMM kernel (8 warps).
SPMM_BLOCK_THREADS = 256
#: Threads per block of the SELL node-step kernel B3 (8 warps; its group
#: form fits lane groups and parts into them, :func:`node_split`).
NODE_STEP_BLOCK_THREADS = 256
#: Threads per block of the ELLPACK node steps B4 / B5 and B4's frontier
#: pass, one thread a node (the better of 128 / 256 for both in both rounds
#: at uniform21 on an H100, if by under 1.5%: ``scripts/graph_ell_variants.py``).
ELL_NODE_BLOCK_THREADS = 128
#: Largest RHS tile the SpMM kernel is instantiated for (its k_tile
#: template values are the powers of two 1 .. 32).
MAX_K_TILE = 32
#: Register bytes a thread may spend on its k_tile accumulators: 64 of
#: the 255 32-bit registers a thread can hold, i.e. 32 fp64 partial sums,
#: leaving the rest for addresses, the loaded (col, val) pair and the
#: gathered X values.
ACC_BYTES_PER_THREAD = 256
#: Value dtypes the SpMM kernel is instantiated for.
KERNEL_DTYPES = ("float32", "float64")
#: Element types of the LM kernels B8 and B9: float32, float64 and the
#: reference model's bf16 storage (B8: bf16 xd / B / C beside float32 ad,
#: sums in float32; B9: bf16 rows, its backward's sums in float32).
LM_KERNEL_DTYPES = ("float32", "float64", "bfloat16")
#: Bytes of one element of each.
DTYPE_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2}
#: Smallest SELL slice height the packer is asked for.
MIN_C = 8
#: Dynamic shared memory one block may claim on an H100: 227 KB of the
#: SM's 256 KB (above 48 KB only after ``cudaFuncSetAttribute``).
SMEM_PER_BLOCK = 232_448
#: Most threads of one block of the in-block FFT kernel (its launch bound:
#: a thread keeps :data:`FFT_BLOCK_RADIX` complex values in registers).
FFT_BLOCK_MAX_THREADS = 512
#: Complex values one thread of the in-block FFT holds in registers, and
#: the radix of its register passes (2048 = 16 x 16 x 8: three passes).
FFT_BLOCK_RADIX = 16
#: Fewest threads the in-block FFT puts in a block while ``b_block``
#: allows: short signals share a block until it has four warps.
FFT_BLOCK_MIN_THREADS = 128
#: One element of padding after every 128 bytes of an in-block FFT plane
#: in shared memory, so that the exchanges between register passes hit
#: distinct banks (``csrc/fft_stockham.cu``).
FFT_BLOCK_PAD_BYTES = 128
#: Bucket width from which kernel B1 splits each row's walk over several
#: threads (narrower buckets keep one thread a row).
SPMM_SPLIT_WIDTH = 128
#: Longest walk (slab entries) one thread of a split bucket makes, while
#: :data:`SPMM_SPLIT_MAX_PARTS` allows it.
SPMM_SPLIT_MAX_CHAIN = 64
#: Shortest walk a split is allowed to leave one thread.
SPMM_SPLIT_MIN_CHAIN = 8
#: Most threads that share one row: a block then holds 8 rows at most
#: 1,024 threads (fewer at wide RHS tiles, :func:`spmm_split_max_threads`).
SPMM_SPLIT_MAX_PARTS = 128
#: Fewest rows a split block holds: 8 lanes of a slab row are one 32 B
#: sector of column indices.
SPMM_SPLIT_MIN_LANES = 8
#: Threads an H100 keeps resident (132 SMs x 2048): a bucket with fewer
#: row-walks than this leaves the card latency-bound, so it is split
#: further (down to :data:`SPMM_SPLIT_MIN_CHAIN`).
SPMM_FILL_THREADS = 132 * 2048
#: RHS columns of the tile whose partial sums a split block reduces per
#: round through shared memory: 1,024 threads x 4 x 8 B = 32 KB at most,
#: below the 48 KB a launch gets without raising its limit.
SPMM_SPLIT_K_CHUNK = 4
#: Width tile kept in the tune schema for the reference's cache format;
#: the Hopper kernel walks a bucket's width in one thread a row, or in
#: :func:`spmm_split` threads a row, so w_block does not shape its launch.
W_BLOCK = 8
#: Static shared memory of one block of the streaming SpMM kernel (B2):
#: the per-warp minima of its chunk walk, one int for each of its 8 warps.
STREAM_STATIC_SMEM = 32


def stream_smem_bytes(col_tile: int, k_tile: int, itemsize: int) -> int:
    """Shared memory one block of kernel B2 claims: two chunks of
    ``col_tile`` staged X rows of ``k_tile`` columns (the chunk in use and
    the one being fetched) and the static per-warp minima."""
    return 2 * int(col_tile) * int(k_tile) * int(itemsize) + STREAM_STATIC_SMEM


@functools.lru_cache(maxsize=256)
def pick_stream_tiles(c: int, k_tile: int = 8,
                      itemsize: int = 8) -> tuple[int, int]:
    """(col_tile, row_tile) of the streaming SpMM schedule (kernel B2).

    The TPU version fills 64 MiB of VMEM with an X tile and a
    (row_tile, C, k_tile) accumulator.  A Hopper block keeps its sums in
    registers (one thread a row, as kernel B1) and stages through shared
    memory only the rows of X its own rows name (the block's column list,
    :class:`repro_torch.sparse.formats.StreamColumnMap`), a chunk of the
    list at a time, double-buffered: ``col_tile`` is the most X rows a
    chunk holds, the largest power of two whose two chunks fit
    :data:`SMEM_PER_BLOCK` (fp64: 8,192 rows at k_tile 1, 256 at k_tile
    32).  ``row_tile`` is what the block's :data:`SPMM_BLOCK_THREADS`
    threads hold: ``threads // C`` slices, at least one (a taller slice is
    split across blocks); a bucket too short to fill the card gets smaller
    blocks (:func:`repro_torch.analysis.preflight.stream_block_rows`).
    """
    ct = 1
    while stream_smem_bytes(2 * ct, max(k_tile, 1), itemsize) <= SMEM_PER_BLOCK:
        ct *= 2
    return ct, max(1, SPMM_BLOCK_THREADS // max(int(c), 1))


@dataclasses.dataclass(frozen=True)
class SpmmSplit:
    """How kernel B1 walks one width bucket.  ``parts`` threads share each
    (slice, lane) row (1: one thread a row, the narrow body); a split block
    holds ``lanes`` consecutive rows x ``parts`` threads, and reduces their
    partial sums through shared memory ``k_chunk`` RHS columns a round
    (``smem_bytes``; the kernel's own constant, min(k_tile, 4))."""

    parts: int
    lanes: int
    k_chunk: int
    itemsize: int = 8

    @property
    def threads(self) -> int:
        return self.lanes * self.parts if self.parts > 1 else SPMM_BLOCK_THREADS

    @property
    def smem_bytes(self) -> int:
        return (self.parts * self.lanes * self.k_chunk * self.itemsize
                if self.parts > 1 else 0)


def spmm_split_max_threads(k_tile: int) -> int:
    """Most threads of one split B1 block at this RHS tile, the kernel's
    launch bound: a thread keeps ``k_tile`` sums and one gathered X tile in
    registers, and a block's threads share 65,536 of them (1,024 threads
    up to k_tile 4, 512 at 8, 256 from 16)."""
    k_tile = int(k_tile)
    return 256 if k_tile >= 16 else 512 if k_tile >= 8 else 1024


def spmm_split(width: int, c: int, n_slices: int, k_tile: int = 1,
               itemsize: int = 8) -> SpmmSplit:
    """The walk of one B1 bucket of ``n_slices`` (``width``, ``c``) slices.

    One thread a row walks all ``width`` entries of it: on big's W = 2048
    bucket that is 64 threads each making 2,048 dependent steps, and the
    bucket's time is that chain's latency, not its bytes.  From
    :data:`SPMM_SPLIT_WIDTH` on, ``parts`` threads share a row (thread p
    walks w = p, p + parts, ...): the smallest power of two that gives the
    card :data:`SPMM_FILL_THREADS` row-walks, held between
    ``width / SPMM_SPLIT_MAX_CHAIN`` (so no walk is longer than that) and
    ``width / SPMM_SPLIT_MIN_CHAIN`` (so no walk is shorter), and at most
    :data:`SPMM_SPLIT_MAX_PARTS` and what a block of
    :func:`spmm_split_max_threads` holds at :data:`SPMM_SPLIT_MIN_LANES`
    rows.  A block is ``lanes`` rows x ``parts``: 32 rows (one warp reads
    32 lanes of one slab row, coalesced) or fewer when the thread budget
    asks, never fewer than :data:`SPMM_SPLIT_MIN_LANES`.  ``k_chunk`` is
    the slice of the ``k_tile`` partial sums reduced per round through
    shared memory (:data:`SPMM_SPLIT_K_CHUNK` at most).
    """
    width, c, n_slices = int(width), int(c), int(n_slices)
    if width < SPMM_SPLIT_WIDTH:
        return SpmmSplit(parts=1, lanes=1, k_chunk=1, itemsize=itemsize)
    rows = max(n_slices * c, 1)
    budget = spmm_split_max_threads(k_tile)
    lo = max(width // SPMM_SPLIT_MAX_CHAIN, 1)
    hi = max(min(width // SPMM_SPLIT_MIN_CHAIN, SPMM_SPLIT_MAX_PARTS,
                 budget // SPMM_SPLIT_MIN_LANES), 1)
    fill = pow2_ceil(-(-SPMM_FILL_THREADS // rows))
    parts = min(max(fill, lo), hi)
    if parts < 2:
        return SpmmSplit(parts=1, lanes=1, k_chunk=1, itemsize=itemsize)
    lanes = min(WARP, budget // parts)
    k_chunk = max(1, min(int(k_tile), SPMM_SPLIT_K_CHUNK))
    return SpmmSplit(parts=parts, lanes=lanes, k_chunk=k_chunk,
                     itemsize=itemsize)


#: Bytes one lane of a B3 node group reads of a neighbour's state row: a
#: 16 B vector (two fp64 or four int32 columns).
NODE_LANE_BYTES = 16
#: Bucket width from which kernel B3 splits a node's walk over several
#: lane groups (narrower buckets keep one group a node).
NODE_SPLIT_WIDTH = 128
#: Longest walk (neighbour slots) one group of a split bucket makes, while
#: the block allows it.
NODE_SPLIT_MAX_CHAIN = 64
#: Shortest walk a split is allowed to leave one group.
NODE_SPLIT_MIN_CHAIN = 8
#: Most threads of one block of B3's group form (its launch bound).
NODE_SPLIT_MAX_THREADS = 1024


@dataclasses.dataclass(frozen=True)
class NodeSplit:
    """How kernel B3 walks one width bucket.  ``group`` lanes of a warp
    serve one node, each holding ``k_tile / group`` state columns;
    ``parts`` groups share one node's walk (1: unsplit); a block holds
    ``nodes`` nodes; at one lane and one part the kernel runs its
    one-thread-a-node body.  ``smem_bytes`` is what a split block claims to
    combine its parts: the PageRank partial sums (``nodes x parts x
    k_tile`` ranks of the state's itemsize) or one BFS hit mask a node."""

    group: int
    parts: int
    nodes: int
    smem_bytes: int

    @property
    def threads(self) -> int:
        return self.nodes * self.parts * self.group


def node_group(k_tile: int, itemsize: int) -> int:
    """Lanes of kernel B3 that serve one node: enough that each reads
    :data:`NODE_LANE_BYTES` of a neighbour's ``k_tile``-column state row
    (PageRank fp64 at k_tile 32: 16; PageRank fp32 and BFS int32: 8), one
    when the row is no wider than that."""
    return max(1, int(k_tile) * int(itemsize) // NODE_LANE_BYTES)


def node_split(width: int, c: int, n_slices: int, k_tile: int,
               itemsize: int, combine: str) -> NodeSplit:
    """The walk of one B3 bucket of ``n_slices`` (``width``, ``c``) slices
    at this state tile of ``itemsize`` bytes a column.  ``combine`` is
    ``"bfs"`` (int32 state) or ``"pagerank"`` (fp64 or fp32 ranks).

    Built as :func:`spmm_split` is: from :data:`NODE_SPLIT_WIDTH` on,
    ``parts`` groups share a node (part p walks w = p, p + parts, ...):
    the smallest power of two that gives the card
    :data:`SPMM_FILL_THREADS` threads, held between ``width /
    NODE_SPLIT_MAX_CHAIN`` (no walk longer) and ``width /
    NODE_SPLIT_MIN_CHAIN`` (no walk shorter), and at most what a block of
    :data:`NODE_SPLIT_MAX_THREADS` holds for one node.  rmat15's one W =
    8192 slice at k = 32 fp64: 64 parts of 16 lanes, walks of 128 slots,
    where one thread walked 8,192.  A block holds
    :data:`NODE_STEP_BLOCK_THREADS` threads' worth of nodes, or one node
    when its parts take more."""
    width, c, n_slices = int(width), int(c), int(n_slices)
    group = node_group(k_tile, itemsize)
    parts = 1
    if width >= NODE_SPLIT_WIDTH:
        rows = max(n_slices * c, 1)
        lo = max(width // NODE_SPLIT_MAX_CHAIN, 1)
        hi = max(min(width // NODE_SPLIT_MIN_CHAIN,
                     NODE_SPLIT_MAX_THREADS // group), 1)
        fill = pow2_ceil(-(-SPMM_FILL_THREADS // (rows * group)))
        parts = min(max(fill, lo), hi)
    nodes = max(1, NODE_STEP_BLOCK_THREADS // (parts * group))
    smem = 0
    if parts > 1:
        smem = (nodes * parts * int(k_tile) * int(itemsize)
                if combine == "pagerank" else 4 * nodes)
    return NodeSplit(group=group, parts=parts, nodes=nodes, smem_bytes=smem)


def fft_block_radix(n: int) -> int:
    """Complex values a thread of the in-block FFT holds: one radix pass's
    butterfly, :data:`FFT_BLOCK_RADIX` or the whole signal when shorter."""
    return min(FFT_BLOCK_RADIX, int(n))


def fft_block_smem_bytes(n: int, signals: int, itemsize: int) -> int:
    """Dynamic shared memory of one in-block FFT block: for each signal one
    re and one im plane of ``n`` elements, each padded by one element per
    :data:`FFT_BLOCK_PAD_BYTES` (the exchange buffer, written in place),
    then the twiddle bases w_n^e for e < n / radix (re and im): the first
    ``n / radix`` entries of row 0 of the registered tables, the only ones
    a register pass reads."""
    plane = n + n // (FFT_BLOCK_PAD_BYTES // itemsize)
    return (2 * int(signals) * plane + 2 * (n // fft_block_radix(n))) * int(itemsize)


def fft_block_signals(n: int, b_block: int, itemsize: int) -> int:
    """Signals one block of the in-block FFT form holds: enough that the
    block has :data:`FFT_BLOCK_MIN_THREADS` threads (one a signal from
    n = 2048 on), never more than ``b_block``.  Such a block's shared
    memory (:func:`fft_block_smem_bytes`) is at most 72 KB, within
    :data:`SMEM_PER_BLOCK`.  0 past :func:`fft_block_limit`: the two-pass
    form runs instead.  Only the grouping depends on ``b_block``, never
    the arithmetic."""
    if n > fft_block_limit(itemsize):
        return 0
    per = n // fft_block_radix(n)
    return min(max(int(b_block), 1), max(1, FFT_BLOCK_MIN_THREADS // per))


#: Streaming multiprocessors of an H100 SXM: the grid size below which a
#: one-wave kernel leaves SMs idle.
SM_COUNT = 132
#: Fewest blocks a B2 launch should give the card (two an SM): a bucket
#: with fewer rows gets smaller blocks, down to one warp
#: (:func:`repro_torch.analysis.preflight.stream_block_rows`).
STREAM_FILL_BLOCKS = 2 * SM_COUNT
#: Most threads of one block of the embedding gather (B9).
GATHER_MAX_THREADS = 256
#: Bytes one B9 thread copies: four 16 B loads in flight before it stores
#: (eight 8 B or sixteen 4 B loads where the rows allow no wider vector).
GATHER_THREAD_BYTES = 64
#: Threads per block of B6, both forms (the best of 128 / 256 / 512 at the
#: 2,097,152-row operand on an H100: ``scripts/b6_variants.py``).
ELL_BLOCK_THREADS = 128
#: Bytes of a row's columns one lane of B6's k-column form holds (and
#: gathers from X in one load): 2 fp64 or 4 fp32 values.
ELL_LANE_BYTES = 16
#: Rows B6's live-width array covers an entry: one warp of the k = 1 body.
ELL_LIVE_ROWS = WARP


def ell_vec(k: int, itemsize: int, aligned: bool = True) -> int:
    """Columns one lane of B6's k-column form holds: 16 B
    (:data:`ELL_LANE_BYTES`) when X's rows of ``k`` values keep every
    lane's piece 16 B aligned (``aligned``: X's base is), else 1."""
    v = ELL_LANE_BYTES // int(itemsize)
    return v if aligned and int(k) % v == 0 else 1


def ell_max_k_tile(vec: int) -> int:
    """Widest k tile of one B6 k-form launch: a group of at most one warp's
    lanes, each ``vec`` columns, so a lane's accumulators and its unrolled
    X pieces stay within its registers."""
    return WARP * int(vec)


def ell_k_tiles(k: int, vec: int) -> list[tuple[int, int, int]]:
    """The launches of B6's k-column form for ``k`` columns: ``(k0, kt,
    group)`` each, columns ``[k0, k0 + kt)`` served by groups of ``group``
    lanes a row (the power of two covering ``kt / vec`` lanes).  Tiles of
    :func:`ell_max_k_tile` columns, the last one ragged: k = 32 fp64 is one
    launch of 16-lane groups, k = 33 (odd, so one column a lane) a 32-lane
    launch and a 1-lane one."""
    tile = ell_max_k_tile(vec)
    tiles = []
    for k0 in range(0, int(k), tile):
        kt = min(tile, int(k) - k0)
        tiles.append((k0, kt, pow2_ceil(-(-kt // int(vec)))))
    return tiles


#: Threads per block of the SSD scan's launches (B8): 16 x 16, each a
#: 4 x 4 register tile of a 64 x 64 output tile.
SSD_BLOCK_THREADS = 256
#: Rows and columns of one B8 output tile: query rows and key rows of the
#: C Bᵀ tile, head columns of y and of the state, state columns.
SSD_TILE = 64
#: k rows one B8 product stages through shared memory a step (of n, or of
#: a chunk's rows): one warp's scan segment.
SSD_K_CHUNK = 32
#: Rows of a chunk B8's block scan covers at once (one a thread).
SSD_SCAN_ROWS = 256
#: Blocks of each B8 launch an SM is guaranteed to hold (the kernels'
#: launch bound caps registers at 65,536 / (256 x 2) a thread).
SSD_MIN_BLOCKS_SM = 2
#: Launches of one ``ssd_fused`` call on the card: chunk states, the
#: state pass over the chunks, chunk outputs.
SSD_LAUNCHES = ("chunk_state", "state_pass", "chunk_output")


#: Launches of one ``ssd_fused_bwd`` call on the card (B8's backward), in
#: order: each chunk's local dY-C term, the reverse state pass, the
#: key-tile side (each tile pair's C Bᵀ and dY Xᵀ computed once, its M and
#: (G ∘ L) tiles to scratch, its row sums handed on; then dX, dB, dcum's
#: column sums and the dS_out terms), the query-tile side (dC from the
#: handed M tiles, dcum's row sums), and the finish (dad, the group sums of
#: dB and dC).
SSD_BWD_LAUNCHES = ("bwd_local", "bwd_state_pass", "bwd_key", "bwd_query",
                    "bwd_finish")


def gather_grid(t: int, row_bytes: int) -> tuple[int, int]:
    """(chunks a row, threads a block) of kernel B9: its grid is (T,
    chunks), block (row, c) copying bytes [c * threads * 64, (c + 1) *
    threads * 64) of row ``ids[row]`` (the last chunk masked at the row's
    end).  A row is cut into as few chunks as :data:`GATHER_MAX_THREADS`
    allow, then, while T rows give fewer than two blocks an SM, into more
    (down to one warp a chunk); the threads are the fewest whole warps
    that cover a chunk.  d = 2560 fp32: one 160-thread chunk a row, so
    T = 512 is 512 blocks; T = 4 is 4 x 5 blocks of one warp."""
    per_warp = WARP * GATHER_THREAD_BYTES
    warps_row = max(1, -(-int(row_bytes) // per_warp))
    chunks = -(-warps_row // (GATHER_MAX_THREADS // WARP))
    chunks = max(chunks, min(warps_row, -(-2 * SM_COUNT // max(int(t), 1))))
    warps = -(-warps_row // chunks)
    return -(-warps_row // warps), warps * WARP


#: Ids B9's backward compacts and sorts in a block's shared memory at a
#: time (8 KB of packed hits, 8 KB of their order); a longer T is walked
#: in slices of this many.
GATHER_BWD_SLICE = 2048
#: Most and fewest table rows of one backward block's stripe (a hit's row
#: is packed into 8 bits).
GATHER_BWD_MAX_STRIPE = 256
GATHER_BWD_MIN_STRIPE = 16
#: Bytes a backward block writes for each id byte it reads: every block
#: reads all T ids (from L2), so its stripe grows with T.
GATHER_BWD_WRITE_PER_ID_BYTE = 16


def gather_bwd_smem_bytes() -> int:
    """Static shared memory of one B9 backward block: the slice's packed
    hits and their order (4 B each), the stripe rows' counts, offsets and
    placed counts (4 B each), a flag and the hit count."""
    s = GATHER_BWD_MAX_STRIPE
    return 8 * GATHER_BWD_SLICE + 4 * (3 * s + 1) + s + 4


def gather_bwd_vec_bytes(row_bytes: int, itemsize: int) -> int:
    """The widest vector (16, 8 or 4 bytes, at least one element) that
    divides a gradient row: each backward thread reads and writes one of
    them of every row it owns."""
    for v in (16, 8, 4):
        if v >= itemsize and int(row_bytes) % v == 0:
            return v
    return int(itemsize)


def gather_bwd_grid(vocab: int, d: int, t: int,
                    itemsize: int) -> tuple[int, int, int, int]:
    """(stripe rows, chunks a row, threads a block, vector bytes) of B9's
    backward: ceil(vocab / stripe) x chunks blocks, block s chunks + c
    owning table rows [s stripe, (s + 1) stripe) and vectors [c threads,
    (c + 1) threads) of each.  Threads: the most whole warps, at most
    :data:`GATHER_MAX_THREADS`, that cut a row into equal chunks (else the
    fewest chunks of at most 256 threads), so a frequent id's run is
    spread over the chunks.  Stripe: a power of two at least
    :data:`GATHER_BWD_WRITE_PER_ID_BYTE` x the id bytes a block reads over
    the bytes it writes a row, in [16, 256], halved while the grid gives
    fewer than two blocks an SM.  mamba2 (V 50,280, d 2560 fp32, T 1024):
    stripe 64, 4 chunks of 160 threads, 16 B vectors: 786 x 4 blocks."""
    vec = gather_bwd_vec_bytes(int(d) * int(itemsize), int(itemsize))
    row_vecs = max(1, int(d) * int(itemsize) // vec)
    threads = 0
    for warps in range(GATHER_MAX_THREADS // WARP, 0, -1):
        if row_vecs % (warps * WARP) == 0:
            threads = warps * WARP
            break
    if not threads:
        chunks = -(-row_vecs // GATHER_MAX_THREADS)
        threads = -(-(-(-row_vecs // chunks)) // WARP) * WARP
    chunks = -(-row_vecs // threads)
    want = GATHER_BWD_WRITE_PER_ID_BYTE * 8 * max(int(t), 1) / (threads * vec)
    stripe = GATHER_BWD_MIN_STRIPE
    while stripe < GATHER_BWD_MAX_STRIPE and stripe < want:
        stripe *= 2
    while stripe > 1 and -(-int(vocab) // stripe) * chunks < 2 * SM_COUNT:
        stripe //= 2
    return stripe, chunks, threads, vec


def _tiles(x: int, t: int = SSD_TILE) -> int:
    return -(-int(x) // t)


def ssd_grids(b: int, l: int, h: int, p: int, n: int,
              chunk: int) -> dict[str, tuple[int, ...]]:
    """Grids of B8's three launches: ``chunk_state`` one block per (b, h,
    chunk) and 64 x 64 tile of the (p, n) state; ``state_pass`` one thread
    per (b, h, p, n) entry, a block per (b, h) and 256 entries; ``chunk_output``
    one block per (b, h, chunk) and 64-row query tile.  At mamba2's prefill
    (b 1: h 80, p 64, n 128, l 512, chunk 256) that is (160, 1, 2), (80,
    32) and (160, 4)."""
    planes = int(b) * int(h) * (int(l) // max(int(chunk), 1))
    return {
        "chunk_state": (planes, _tiles(p), _tiles(n)),
        "state_pass": (int(b) * int(h), _tiles(int(p) * int(n),
                                               SSD_BLOCK_THREADS)),
        "chunk_output": (planes, _tiles(chunk)),
    }


def ssd_smem_bytes(launch: str, itemsize: int) -> int:
    """Dynamic shared memory of one block of a B8 launch, the same whatever
    the shape: both tiled launches stage their operands in two stages of
    two (32, 68) tiles; ``chunk_state`` adds a 256-row segment's cum and
    decays and the 8 warp totals of its scan; ``chunk_output`` the (64, 68)
    decay-weighted C Bᵀ tile and 2 x 64 cum values (its x tile reuses a
    stage; in fp32, its tensor-core form, the stages hold row-major (64,
    36) tiles); ``state_pass`` none.  fp32: 37 KB and 55 KB; fp64: 74 KB
    and 105 KB."""
    lds = SSD_TILE + 4
    stages = 2 * 2 * SSD_K_CHUNK * lds
    if launch == "chunk_output" and int(itemsize) == 4:
        # the tensor-core form: row-major (64, 36) operand tiles
        stages = 2 * 2 * SSD_TILE * (SSD_K_CHUNK + 4)
    elems = {"chunk_state": stages + 2 * SSD_SCAN_ROWS
             + SSD_BLOCK_THREADS // WARP,
             "state_pass": 0,
             "chunk_output": stages + SSD_TILE * lds + 2 * SSD_TILE}[launch]
    return elems * int(itemsize)


def ssd_bwd_grids(b: int, l: int, h: int, p: int, g: int, n: int,
                  chunk: int) -> dict[str, tuple[int, ...]]:
    """Grids of B8's five backward launches: ``bwd_local`` as the forward's
    ``chunk_state`` (a block per (b, h, chunk) and 64 x 64 tile of (p, n)),
    ``bwd_state_pass`` as its ``state_pass``, ``bwd_key`` / ``bwd_query``
    one block per (b, h, chunk) and 64-row tile, ``bwd_finish`` one thread
    per element of dB (b, l, g, n) or one warp per (b, h, chunk), whichever
    is more, three planes (dad, dB, dC).  mamba2 at (2, 512): (320, 1, 2), (160,
    32), (320, 4), (320, 4) and (512, 3)."""
    grids = ssd_grids(b, l, h, p, n, chunk)
    planes = grids["chunk_output"][0]
    most = max(int(b) * int(l) * int(g) * int(n), WARP * planes)
    return {
        "bwd_local": grids["chunk_state"],
        "bwd_state_pass": grids["state_pass"],
        "bwd_key": grids["chunk_output"],
        "bwd_query": grids["chunk_output"],
        "bwd_finish": (_tiles(most, SSD_BLOCK_THREADS), 3),
    }


def ssd_bwd_pairs(l: int, chunk: int) -> int:
    """(query tile, key tile) pairs on and below the diagonal of one chunk
    (64-row tiles): the key launch hands the query launch one M tile and 64
    row sums for each.  chunk 256: 10."""
    t = _tiles(chunk)
    return t * (t + 1) // 2


#: Stages of B8's backward pipelines (launches 1, 3 and 4): every step is a
#: k-step of 32 over two tiles of 4608 elements (a product over a tile's
#: 64 rows takes two), four of them in shared memory.
SSD_BWD_STAGES = 4


def ssd_bwd_smem_bytes(launch: str, itemsize: int) -> int:
    """Dynamic shared memory of one block of a B8 backward launch, fixed
    whatever the shape (``csrc/ssd_bwd.cu``): :data:`SSD_BWD_STAGES` stages
    of a k-step's two (64, 36) or (32, 72) tiles (4608 elements);
    ``bwd_local`` adds 32 decay scales a stage; ``bwd_key`` a (64, 65) tile
    for row and column sums, 3 x 64 cum and dcum values and 8 warp sums;
    ``bwd_query`` the sums tile and 64 cum values.  fp32: 73, 89 and 89 KB
    (two blocks an SM); fp64 twice that."""
    t, kc = SSD_TILE, SSD_K_CHUNK
    stages = SSD_BWD_STAGES * 2 * t * (kc + 4)
    sums = t * (t + 1)
    elems = {"bwd_local": stages + SSD_BWD_STAGES * kc, "bwd_state_pass": 0,
             "bwd_key": stages + sums + 3 * t + SSD_BLOCK_THREADS // WARP,
             "bwd_query": stages + sums + t,
             "bwd_finish": 0}[launch]
    return elems * int(itemsize)


def ssd_bwd_flops(b: int, l: int, h: int, p: int, n: int, chunk: int) -> int:
    """Operations of the scan's backward as a function: per (b, h) and
    chunk, q(q+1)/2 entries each of C Bᵀ (n multiply-adds), dY Xᵀ (p) and
    of their products into dC (n), dB (n) and dX (p), then the local term
    and the three dS terms (q n p each), two operations a multiply-add.
    mamba2 at (2, 512): 16.15 GFLOP."""
    q = int(chunk)
    per = q * (q + 1) * (3 * int(n) + 2 * int(p)) + 8 * q * int(n) * int(p)
    return int(b) * int(h) * (int(l) // q) * per


def ssd_warps_per_sm(grid: tuple[int, ...], smem_bytes: int) -> int:
    """Warps every SM holds at once in a B8 launch of ``grid``: its blocks
    a wave spread over :data:`SM_COUNT` SMs, at most
    :data:`SSD_MIN_BLOCKS_SM` each (the launch bound's guarantee) and as
    many as the shared memory allows.  mamba2's prefill at b 1: 16 in both
    tiled launches."""
    blocks = 1
    for g in grid:
        blocks *= int(g)
    fit = SMEM_PER_BLOCK // max(int(smem_bytes), 1)
    per_sm = min(SSD_MIN_BLOCKS_SM, fit, blocks // SM_COUNT)
    return per_sm * (SSD_BLOCK_THREADS // WARP)


def ssd_flops(b: int, l: int, h: int, p: int, n: int, chunk: int) -> int:
    """Operations of the scan's function: per (b, h) and chunk, q(q+1)/2
    entries of C Bᵀ (n multiply-adds each) and of its product with x (p
    each), the chunk's state (q n p) and the carried-state term (q n p),
    two operations a multiply-add.  mamba2's prefill at b 1: 3.363 GFLOP."""
    q = int(chunk)
    per = q * (q + 1) * (int(n) + int(p)) + 4 * q * int(n) * int(p)
    return int(b) * int(h) * (int(l) // q) * per


def ssd_flops_executed(b: int, l: int, h: int, p: int, n: int, chunk: int,
                       init: bool = False) -> dict[str, int]:
    """Operations B8's launches execute, tiles padded: ``chunk_state``
    (64-padded p and n, 32-padded chunk rows), ``state_term`` (the
    carried-state product, skipped for chunk 0 without an initial state),
    ``cb`` (the C Bᵀ tiles on and below the diagonal, each once) and
    ``gx`` (their products with x)."""
    q, nc = int(chunk), int(l) // int(chunk)
    t, kc = SSD_TILE, SSD_K_CHUNK
    pp, nn = _tiles(p) * t, _tiles(n) * t
    nk = _tiles(n, kc) * kc
    qk, r = _tiles(q, kc) * kc, _tiles(q)
    tri = r * (r + 1) // 2
    planes = int(b) * int(h)
    state_chunks = nc if init else nc - 1
    return {
        "chunk_state": planes * nc * 2 * qk * pp * nn,
        "state_term": planes * state_chunks * 2 * r * t * nk * pp,
        "cb": planes * nc * tri * 2 * t * t * nk,
        "gx": planes * nc * tri * 2 * t * t * pp,
    }


def ssd_bytes(b: int, l: int, h: int, p: int, g: int, n: int, itemsize: int,
              acc_itemsize: int, init: bool = False) -> int:
    """Least bytes of the scan as a function: xd, B and C read and y
    written once in their dtype, ad read and the final state (and any
    initial state) in the accumulation dtype.  mamba2's prefill at b 1
    fp32: 21.0 MB."""
    b, l, h, p, g, n = (int(v) for v in (b, l, h, p, g, n))
    states = b * h * p * n * (2 if init else 1)
    return int(itemsize) * (2 * b * l * h * p + 2 * b * l * g * n) \
        + int(acc_itemsize) * (b * l * h + states)


def ssd_bwd_bytes(b: int, l: int, h: int, p: int, g: int, n: int,
                  chunk: int, itemsize: int, acc_itemsize: int) -> int:
    """Least bytes of the backward: xd, dy and dX (and B, C, dB, dC) once
    in their dtype; ad, dad, the forward's cum, its entering states and
    its final state in the accumulation dtype."""
    b, l, h, p, g, n = (int(v) for v in (b, l, h, p, g, n))
    nc = l // int(chunk)
    return int(itemsize) * (3 * b * l * h * p + 4 * b * l * g * n) \
        + int(acc_itemsize) * (2 * b * l * h + b * h * l + b * h * nc * p * n
                               + b * h * p * n)


def gather_bytes(t: int, d: int, itemsize: int, owned: int | None = None) -> int:
    """Least bytes of kernel B9: each gathered row read and each output row
    written once, each (int64) id read once: 2·T·d·itemsize + 8·T.  The
    vocab-shard form (``owned``: the ids whose row the shard holds) writes
    every row and reads only its own: (T + owned)·d·itemsize + 8·T."""
    t, d = int(t), int(d)
    reads = t if owned is None else int(owned)
    return (t + reads) * d * int(itemsize) + 8 * t


def gather_bwd_bytes(rows: int, t: int, d: int, table_itemsize: int,
                     dout_itemsize: int, owned: int | None = None) -> int:
    """Least bytes of B9's backward: the (rows, d) gradient written once,
    each summed row of dout read once (the shard form: its ``owned`` ones;
    the whole table: all T), each id read once: rows·d·table_itemsize +
    owned·d·dout_itemsize + 8·T."""
    t, d = int(t), int(d)
    reads = t if owned is None else int(owned)
    return int(rows) * d * int(table_itemsize) + reads * d * int(dout_itemsize) \
        + 8 * t


#: Most columns one pass-A block of the two-pass FFT holds (the tile T):
#: its T adjacent columns make each row segment it reads and writes T
#: elements long (T >= 4 in fp64: a 32 B sector).
FFT_PASS_TILE_A = 8
#: Most rows one pass-B block holds: the T adjacent k1 of one k2 it writes
#: are one segment (32 B at T = 4 in fp64).
FFT_PASS_TILE_B = 4
#: Most threads of one block of either two-pass launch.
FFT_PASS_THREADS = 1024


def fft_block_limit(itemsize: int) -> int:
    """Longest signal the in-block form takes: 4096 in fp64, 8192 in fp32,
    the lengths whose two planes fit a block's shared memory twice over.
    The two-pass form takes longer signals, and its sub-lengths are capped
    here too."""
    n = 2
    while 4 * (2 * n) * itemsize <= SMEM_PER_BLOCK:
        n *= 2
    return n


def fft_pass_smem_bytes(m: int, tile: int, itemsize: int, pad: int) -> int:
    """Shared memory of one two-pass block: two planes, ping-pong, ``tile``
    sub-signals of length ``m``, each padded by ``pad`` elements (pass B
    pads its rows by its tile, so its column reads hit distinct banks),
    and the sub-FFT's twiddles w_m^q for q < m / 2 (m elements)."""
    return (4 * tile * (m + pad) + m) * itemsize


def fft_pass_tile(m: int, count: int, itemsize: int, padded: bool,
                  most: int) -> int:
    """Sub-signals of length ``m`` one two-pass block transforms: the
    largest power of two up to ``most`` and ``count`` (the sub-signals
    there are) whose buffers fit a block."""
    t = 1
    while (2 * t <= min(most, count)
           and fft_pass_smem_bytes(m, 2 * t, itemsize,
                                   2 * t if padded else 0) <= SMEM_PER_BLOCK):
        t *= 2
    return t


def fft_two_pass(n: int, itemsize: int) -> tuple[int, int, int, int] | None:
    """(n1, n2, pass A's tile, pass B's tile) of the two-pass FFT form at
    length ``n``.  n = n1 * n2 with n1 = 2^floor(log2 n / 2) (2^17 = 256 x
    512): pass A's columns are the shorter sub-signals, so its tiles of
    columns are the wider.  None where n2 exceeds :func:`fft_block_limit`,
    i.e. n beyond 2^24 in fp64 and 2^26 in fp32.  Pass A holds ``tile`` of
    the n2 columns of length n1 (at most :data:`FFT_PASS_TILE_A`), pass B
    ``tile`` of the n1 rows of length n2 (at most :data:`FFT_PASS_TILE_B`,
    rows padded by the tile)."""
    n1 = 1 << ((int(n).bit_length() - 1) // 2)
    n2 = int(n) // n1
    if n2 > fft_block_limit(itemsize):
        return None
    return (n1, n2,
            fft_pass_tile(n1, n2, itemsize, False, FFT_PASS_TILE_A),
            fft_pass_tile(n2, n1, itemsize, True, FFT_PASS_TILE_B))


def fft_pass_threads(m: int, tile: int) -> int:
    """Threads of one two-pass block: one per radix-4 butterfly of its
    ``tile * m / 4`` (radix 2 when m = 2), rounded up to a warp, at most
    :data:`FFT_PASS_THREADS`."""
    work = tile * max(m // 4, 1)
    return min(FFT_PASS_THREADS, WARP * -(-work // WARP))


def fft_block_threads(n: int, signals: int) -> int:
    """Threads of one in-block FFT block: ``n / radix`` a signal
    (:func:`fft_block_radix`), 128 at n = 2048."""
    return int(signals) * (int(n) // fft_block_radix(n))


@dataclasses.dataclass(frozen=True)
class SellTuneResult:
    """A tuned SELL layout; the same fields as the reference's, so the
    TuneCache JSON schema is shared between the packages.  The port ranks
    by pad factor, so its ``cycles`` (the score) is the pad factor."""

    c: int
    sigma: int
    w_block: int
    cycles: float
    pad_factor: float
    #: (c, sigma, measured pad_factor, score) per candidate
    table: tuple[tuple[int, int, float, float], ...]
    #: RHS tile of the batched SpMM core (RHS columns one thread carries)
    k_block: int = 8
    #: streaming-schedule tiles (kernel B2) for this layout, from
    #: :func:`pick_stream_tiles` at ``k_block`` and fp64: what a caller that
    #: streams the tuned layout passes as ``ExecSpec.col_tile`` /
    #: ``row_tile``.  Nothing in the port reads them (``auto`` never
    #: streams, and ``ops`` picks tiles at the k tile that runs); they keep
    #: the tune cache's entries in the reference's schema
    col_tile: int = 256
    row_tile: int = 1


def candidate_vls(max_vl: int = 1024, min_vl: int = MIN_C) -> list[int]:
    """Power-of-two slice heights from ``min_vl`` up to ``max_vl``."""
    out = []
    v = min_vl
    while v <= max_vl:
        out.append(v)
        v *= 2
    return out


@dataclasses.dataclass(frozen=True)
class TuneResult:
    vl: int
    cycles: float
    table: tuple[tuple[int, float], ...]   # (vl, modeled cycles) per candidate

    def speedup_over_worst(self) -> float:
        worst = max(c for _, c in self.table)
        return worst / self.cycles


def tune_vl(
    trace_builder: Callable[[VectorConfig], Trace],
    machine: MachineParams | None = None,
    candidates: Sequence[int] | None = None,
    bytes_per_vl_row: float = 0.0,
    smem_budget: float = SMEM_PER_BLOCK,
) -> TuneResult:
    """Pick the vector length minimizing SDV-modeled cycles under a budget.

    The reference's ``tune_vl`` with the Hopper budget: a block of width
    ``vl`` must fit ``bytes_per_vl_row * vl`` bytes of shared memory
    (``smem_budget``, by default the :data:`SMEM_PER_BLOCK` one block may
    claim; ``bytes_per_vl_row = 0`` is no bound), and the default machine
    is :func:`repro_torch.core.sdv.h100_machine`, whose latencies are
    estimates (ROADMAP A14).  With the machine, candidates and budget
    passed explicitly, the result equals the reference's.
    """
    machine = machine or h100_machine()
    cands = list(candidates) if candidates is not None else candidate_vls()
    sdv = SDVMachine(machine)
    rows: list[tuple[int, float]] = []
    for vl in cands:
        if bytes_per_vl_row and bytes_per_vl_row * vl > smem_budget:
            continue
        cycles = sdv.run(trace_builder(VectorConfig(vl=vl, lanes=machine.lanes))).cycles
        rows.append((vl, cycles))
    if not rows:
        raise ValueError("no candidate vl fits the shared-memory budget")
    best_vl, best_cycles = min(rows, key=lambda r: r[1])
    return TuneResult(vl=best_vl, cycles=best_cycles, table=tuple(rows))


def measured_pad_factor(
    row_lengths: np.ndarray, c: int, sigma: int, pow2_buckets: bool = True
) -> float:
    """padded_nnz / nnz of the SELL-C-sigma layout on *these* row lengths.

    Computed with the packer's own helpers (sigma-window sort, per-C-slice
    max width, power-of-two bucket rounding) without building the layout,
    so the tuner can sweep (C, sigma) cheaply and can never disagree with
    what :func:`repro_torch.sparse.formats.csr_to_sell_slabs` builds.
    """
    n = len(row_lengths)
    if n == 0:
        return 1.0
    lengths = np.asarray(row_lengths, np.int64)
    order = sigma_sort_order(lengths, sigma)
    widths = slice_widths(lengths, order, c)
    if pow2_buckets:
        widths = next_pow2(widths)
    return float(widths.sum() * c) / max(int(lengths.sum()), 1)


def pick_k_block(elem_bytes: int = 8, k_max: int = MAX_K_TILE) -> int:
    """Largest power-of-two RHS tile whose accumulators fit a thread.

    One thread of the SpMM kernel owns one (slice, lane) row and carries
    ``k_tile`` running sums in registers across the whole bucket width, so
    the tile is bounded by :data:`ACC_BYTES_PER_THREAD` — 32 at fp64 — and
    by the kernel's instantiations (:data:`MAX_K_TILE`).  X is gathered
    from device memory whatever its size, so ``n_cols`` does not enter.
    Wider is better up to the cap: each slab entry loaded is reused across
    every RHS column of the tile.
    """
    k = 1
    while k * 2 <= k_max and (k * 2) * elem_bytes <= ACC_BYTES_PER_THREAD:
        k *= 2
    return k


def tune_sell_layout(
    row_lengths: np.ndarray,
    candidates_c: Sequence[int] | None = None,
    sigma_factors: Sequence[int] = (1, 4, 8, 32),
    cache=None,
    cache_key: str | None = None,
    n_devices: int = 1,
) -> SellTuneResult:
    """Co-select (C, sigma) and the RHS tile for the SELL SpMM kernel.

    For every candidate the tuner *measures* the pad factor the packer
    would produce on the given row lengths and keeps the least (the first
    candidate on a tie).  B1 reads every padded slab entry, so the pad
    factor is what the layout adds to its bytes.  Without explicit
    ``candidates_c`` the sweep prefers slice heights that are whole warps
    (32 .. 1024): a C below 32 leaves a warp straddling slices of different
    widths.  Smaller C are swept only when the operand has fewer than 32
    rows.  X's size does not enter the Hopper tune.

    ``cache``/``cache_key`` plug in a persistent tune store (duck-typed
    ``get_sell``/``put_sell``, e.g.
    :class:`repro_torch.service.tunecache.TuneCache`): the cache is
    consulted before any pad factor is measured, and a miss records its
    result.

    ``n_devices > 1`` tunes for the row-sharded drive, as the reference
    does: each device packs its own row range, so the tuner scores the
    busiest shard (the largest nnz under the partition
    :func:`repro_torch.sparse.formats.shard_row_ranges` makes), which sets
    the drive's critical path.  Key the cache with the same device count
    (``TuneCache.sell_key(n_devices=...)``).
    """
    if cache is not None and cache_key is not None:
        hit = cache.get_sell(cache_key)
        if hit is not None:
            return hit
    lengths = np.asarray(row_lengths, np.int64)
    if int(n_devices) > 1 and len(lengths):
        ranges = shard_row_ranges(lengths, int(n_devices))
        lo, hi = max(ranges, key=lambda r: int(lengths[r[0]:r[1]].sum()))
        lengths = lengths[lo:hi]
    n_rows = len(lengths)
    if candidates_c is not None:
        cands = list(candidates_c)
    else:
        cands = [v for v in candidate_vls() if v <= max(n_rows, MIN_C)]
        cands = [v for v in cands if v % WARP == 0] or cands
    if not cands:
        raise ValueError("no candidate slice height C to tune over")
    rows: list[tuple[int, int, float, float]] = []
    for c in cands:
        seen: set[int] = set()
        for f in sigma_factors:
            sigma = min(max(f * c, c), max(n_rows, 1))
            if sigma in seen:
                continue
            seen.add(sigma)
            pf = measured_pad_factor(lengths, c, sigma)
            rows.append((c, sigma, pf, pf))
    best = min(rows, key=lambda r: r[3])
    k_block = pick_k_block()
    col_tile, row_tile = pick_stream_tiles(best[0], k_block)
    result = SellTuneResult(
        c=best[0],
        sigma=best[1],
        w_block=W_BLOCK,
        cycles=best[3],
        pad_factor=best[2],
        table=tuple(rows),
        k_block=k_block,
        col_tile=col_tile,
        row_tile=row_tile,
    )
    if cache is not None and cache_key is not None:
        cache.put_sell(cache_key, result)
    return result
