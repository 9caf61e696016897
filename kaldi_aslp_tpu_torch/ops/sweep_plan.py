"""Launch plans of the persistent LSTMP sweeps, in Python so that the CPU
tests can check them.

Four kernel pairs take these plans as arguments and check that each gives
the byte count of the shared-memory layout they use:

  - the x-fused BLSTMP sweeps (csrc/bilstmp_sweep.cuh, ``fwd_sweep_kernel``
    and ``bwd_sweep_kernel``, built in csrc/bilstmp_train.cu):
    :func:`sweep_plan`;
  - the xg-fed BLSTMP pair (csrc/bilstmp_xg_train.cu): the same sweeps with
    bf16 products, the FMA sweeps ``xg_fma_fwd_sweep_kernel`` /
    ``xg_fma_bwd_sweep_kernel`` with float32 products, or past their
    capacity the per-step kernels: :func:`bilstmp_xg_plan`;
  - the unidirectional LSTMP sweeps (csrc/lstmp_train.cu,
    ``lstmp_fwd_sweep_kernel`` and ``lstmp_bwd_sweep_kernel``):
    :func:`lstmp_sweep_plan`;
  - the LSTMP inference sweeps (csrc/lstmp_forward.cu,
    ``lstmp_few_sweep_kernel`` and ``lstmp_infer_sweep_kernel``), one or
    two directions a launch: :func:`lstmp_infer_plan`.

All share the limit of one block's dynamic shared memory and the
constants of csrc/sweep.cuh; the limits below are those files' constants
(tests/test_torch_bilstmp_plan.py, tests/test_torch_bilstmp_xg_plan.py and
tests/test_torch_lstmp_plan.py hold them equal)."""

from __future__ import annotations

import math
from dataclasses import dataclass

SMEM_LIMIT = 232_448      # dynamic shared memory one block may use (H100)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


# -- the x-fused BLSTMP sweeps ------------------------------------------------
#
# 256 threads a block.  The limits are csrc/bilstmp_sweep.cuh's kRowsMax,
# kKC, kMaxCells, kMaxCols and kMaxStages.

ROWS_PER_PASS = 128       # streams per pass of a product (8 m16 tiles)
K_CHUNK = 64              # columns per chunk of the cp.async ring
MAX_CELLS = 16            # cells a block may own (64 gate rows)
MAX_COLS = 64             # projection columns a block may own
MIN_CELLS = 8             # cells a block owns at least (32 gate rows)
MAX_STAGES = 4            # deepest cp.async ring


def _sweep_smem(S: int, C: int, P: int, cpb: int, ppb: int, stages: int,
                backward: bool, xg_bf16: bool = False) -> int:
    """Bytes of a sweep block's dynamic shared memory: its weight slices
    (bf16 rows of K + 8), the cp.async ring, the product's float32 output,
    the state of its cells and columns, in the backward the seven
    per-(stream, cell) sums, and what the epilogues read, prefetched while
    the product runs (forward: a pass's xg of the owned cells, float32 or
    with ``xg_bf16`` bf16 in groups of 8, and its mask; backward: its bf16
    gates and c_prev of the owned cells, dy of the owned columns at two
    frames, two frames of mask); each region rounded up to 16 bytes."""
    cp, pp = _round_up(C, 16), _round_up(P, 16)
    n1 = _round_up(cpb if backward else 4 * cpb, 8)
    n2 = _round_up(ppb, 8)
    ld2 = (4 * cp if backward else cp) + 8
    mg = min(ROWS_PER_PASS, _round_up(S, 16))
    regions = [2 * n1 * (pp + 8), 2 * n2 * ld2,
               2 * stages * mg * (K_CHUNK + 8), 4 * mg * (max(n1, n2) + 4),
               4 * S * cpb, 4 * S * ppb]
    if backward:
        c8 = _round_up(cpb, 8)
        regions += [4 * 7 * S * cpb, 2 * mg * 4 * c8, 2 * mg * c8,
                    2 * mg * 2 * ppb, 4 * mg * 2]
    else:
        xg = 2 * mg * 4 * _round_up(cpb, 8) if xg_bf16 else \
            4 * mg * 4 * _round_up(cpb, 4)
        regions += [xg, 4 * mg]
    return sum(_round_up(r, 16) for r in regions)


@dataclass(frozen=True)
class SweepPlan:
    """How a persistent sweep lays out one direction: ``blocks_per_dir``
    blocks, block b owning cells ``cells(b)`` (its rows of W_r, and of
    W_rm^T in the backward) and projection columns ``cols(b)`` (its rows of
    W_rm, and of W_r^T in the backward); rings of ``stages_fwd`` /
    ``stages_bwd`` K_CHUNK-column chunks; ``smem_fwd`` / ``smem_bwd`` bytes
    of dynamic shared memory.  A launch of ndir directions runs
    ndir * blocks_per_dir blocks with the same plan per direction.  A
    block may own cells and no columns, or columns and no cells."""
    S: int
    C: int
    P: int
    blocks_per_dir: int
    cells_per_block: int
    cols_per_block: int
    stages_fwd: int
    stages_bwd: int
    smem_fwd: int
    smem_bwd: int

    def cells(self, b: int) -> range:
        j0 = b * self.cells_per_block
        return range(min(j0, self.C), min(j0 + self.cells_per_block, self.C))

    def cols(self, b: int) -> range:
        p0 = b * self.cols_per_block
        return range(min(p0, self.P), min(p0 + self.cols_per_block, self.P))

    def k_chunks(self, product: str):
        """The (k0, width) chunks, in the order every output element of a
        sweep product is summed over them: ``gates`` ([S, P] x W_r^T),
        ``proj`` ([S, C] x W_rm^T), ``dm`` ([S, P] x W_rm) or ``dr``
        ([S, 4C] x W_r, K laid out gate * C_pad + j)."""
        cp, pp = _round_up(self.C, 16), _round_up(self.P, 16)
        k = {"gates": pp, "proj": cp, "dm": pp, "dr": 4 * cp}[product]
        return [(k0, min(K_CHUNK, k - k0)) for k0 in range(0, k, K_CHUNK)]

    def kernel_args(self, backward: bool):
        """(nbd, cpb, ppb, stages, smem) as the C entries take them."""
        return (self.blocks_per_dir, self.cells_per_block,
                self.cols_per_block,
                self.stages_bwd if backward else self.stages_fwd,
                self.smem_bwd if backward else self.smem_fwd)


def _deepest_ring(smem_at, limit: int = SMEM_LIMIT):
    """(stages, bytes) of the deepest ring from MAX_STAGES down to 2 whose
    layout ``smem_at(stages)`` fits, or None."""
    for stages in range(MAX_STAGES, 1, -1):
        smem = smem_at(stages)
        if smem <= limit:
            return stages, smem
    return None


def sweep_plan(S: int, C: int, P: int, num_sms: int,
               xg_bf16: bool = False) -> SweepPlan:
    """The launch plan of the x-fused sweeps at these widths on a card of
    ``num_sms`` SMs: MIN_CELLS to MAX_CELLS cells a block over at most
    floor(num_sms / 2) blocks a direction (both directions' blocks
    resident at once, one an SM); as many blocks as the cells need, or as
    the projection's groups of 8 columns need if that is more (so no block
    owns two groups while another could own one: a backward W_r^T slice of
    two groups is twice as large); the columns in groups of 8 (16-byte
    loads); and for each sweep the deepest ring (MAX_STAGES down to 2
    chunks) that fits SMEM_LIMIT.  ``xg_bf16``: the forward prefetches
    bf16 xg (the xg-fed pair's layout), not float32.

    Capacity: C <= MAX_CELLS * floor(num_sms / 2) (1056 on an H100's 132
    SMs), at most MAX_COLS columns a block, and the shared memory.  With
    C <= 1024 and P <= 512 every S <= 128 fits; the per-stream state (and
    the backward's seven per-(stream, cell) sums) takes 4 S (8 cpb + ppb)
    bytes more, so past 128 streams the widths that fit narrow, and the
    error names the most streams that fit at the widths asked.  Past the
    capacity it raises ValueError."""
    if min(S, C, P) <= 0:
        raise ValueError(f"S, C, P must be positive, got {S, C, P}")
    per_dir = num_sms // 2
    if per_dir < 1:
        raise ValueError(f"a card of {num_sms} SMs cannot hold both "
                         "directions' sweeps")
    cpb = max(MIN_CELLS, math.ceil(C / per_dir))
    if cpb > MAX_CELLS:
        raise ValueError(
            f"cell dim C={C} is past the sweep's capacity: at most "
            f"{MAX_CELLS} cells in each of {per_dir} blocks a direction, "
            f"C <= {MAX_CELLS * per_dir} on {num_sms} SMs")
    nbd = min(per_dir, max(math.ceil(C / cpb), math.ceil(P / 8)))
    ppb = _round_up(math.ceil(P / nbd), 8)
    if ppb > MAX_COLS:
        raise ValueError(
            f"projection dim P={P} is past the sweep's capacity: at most "
            f"{MAX_COLS} columns in each of {nbd} blocks, P <= "
            f"{MAX_COLS * nbd} at C={C}")
    fits = {}
    for backward in (False, True):
        def smem_at(stages, s=S):
            return _sweep_smem(s, C, P, cpb, ppb, stages, backward, xg_bf16)
        fits[backward] = _deepest_ring(smem_at)
        if fits[backward] is None:
            s_max = 0
            while _deepest_ring(lambda st: smem_at(st, s_max + 1)):
                s_max += 1
            raise ValueError(
                f"(S, C, P) = {S, C, P} is past the sweep's capacity: a "
                f"block needs {smem_at(2)} bytes of shared memory, more "
                f"than the {SMEM_LIMIT} it may use; at C={C}, P={P} at "
                f"most S={s_max} streams fit")
    (sf, mf), (sb, mb) = fits[False], fits[True]
    return SweepPlan(S, C, P, nbd, cpb, ppb, sf, sb, mf, mb)


# -- the unidirectional LSTMP sweeps ------------------------------------------
#
# 256 threads a block, float32 products from shared memory.  The limits are
# csrc/lstmp_train.cu's kUniRows, kUniKC, kUniMaxCells and kUniMaxStages;
# UNI_MIN_CELLS is the plan's own choice.

UNI_ROWS_PER_PASS = 128   # streams per pass of a block's products
UNI_K_CHUNK = 64          # columns of the state row per ring chunk
UNI_MAX_CELLS = 16        # cells a block may own (64 gate rows)
UNI_MIN_CELLS = 4         # cells a block owns at least (fewer partials)
UNI_MAX_STAGES = 8        # deepest cp.async ring


def _uni_smem(S: int, C: int, P: int, cpb: int, stages: int,
              backward: bool) -> int:
    """Bytes of a unidirectional sweep block's dynamic shared memory, all
    float32: the block's two weight slices, the cp.async ring that stages
    the step's state row ([rows][UNI_K_CHUNK + 4] a chunk) and the pass's
    local operand of the second product (m of the owned cells in the
    forward, their dgates in the backward).  Forward: W_r's gate rows of
    the owned cells as [pp][4 cpb] and W_rm's columns of them as
    [cpb4][pp]; backward: W_rm's columns as [pp][cpb4] and W_r's gate rows
    as [4 cpb][pp] (pp = P rounded up to 4, cpb4 = cpb rounded up to 4)."""
    pp, cpb4 = _round_up(P, 4), _round_up(cpb, 4)
    mg = min(UNI_ROWS_PER_PASS, _round_up(S, 4))
    k2 = 4 * cpb if backward else cpb4
    regions = [4 * pp * (cpb4 if backward else 4 * cpb), 4 * k2 * pp,
               4 * stages * mg * (UNI_K_CHUNK + 4), 4 * mg * k2]
    return sum(_round_up(r, 16) for r in regions)


@dataclass(frozen=True)
class LstmpSweepPlan:
    """How the unidirectional training pair runs.  ``persistent``: each
    sweep is one cooperative kernel of ``blocks`` blocks, block b owning
    cells ``cells(b)`` (their four gate rows of W_r and their columns of
    W_rm), a ring of ``stages`` chunks, ``smem_fwd`` / ``smem_bwd`` bytes
    of shared memory, and a scratch of ``blocks`` partial [S, pp] sums of
    the step's second product.  Otherwise (``reason`` says why) the pair
    runs the per-step kernels, two launches a frame each way."""
    S: int
    C: int
    P: int
    persistent: bool
    blocks: int
    cells_per_block: int
    stages: int
    smem_fwd: int
    smem_bwd: int
    reason: str = ""

    def cells(self, b: int) -> range:
        j0 = b * self.cells_per_block
        return range(min(j0, self.C), min(j0 + self.cells_per_block, self.C))

    @property
    def path(self) -> str:
        return "persistent" if self.persistent else "per_step"

    def kernel_args(self, backward: bool):
        """(blocks, cpb, stages, smem) as the C entries take them; all 0
        for the per-step kernels."""
        if not self.persistent:
            return (0, 0, 0, 0)
        return (self.blocks, self.cells_per_block, self.stages,
                self.smem_bwd if backward else self.smem_fwd)

    def scratch_words(self) -> int:
        """float32 words of the partial sums [blocks, S, pp] plus the state
        row [S, pp]."""
        pp = _round_up(self.P, 4)
        return (self.blocks + 1) * self.S * pp if self.persistent else 0


def lstmp_sweep_plan(S: int, C: int, P: int, num_sms: int) -> LstmpSweepPlan:
    """The unidirectional pair's plan on a card of ``num_sms`` SMs:
    UNI_MIN_CELLS to UNI_MAX_CELLS cells a block over at most ``num_sms``
    blocks (all resident, one an SM), and the deepest ring (UNI_MAX_STAGES
    down to 2) with which both sweeps fit SMEM_LIMIT.

    Capacity of the persistent sweeps: C <= UNI_MAX_CELLS * num_sms (2112
    on an H100's 132 SMs) and both layouts within SMEM_LIMIT with a ring
    of at least 2 chunks; the weights take 20 cpb (P rounded up to 4)
    bytes and the ring 272 bytes a stream and chunk.  At P = 512 that is
    every C <= 2112 at S <= 64, C <= 1848 at S = 100 and C <= 1584 at
    S = 128.  Past it the plan selects the per-step
    kernels (``persistent`` False), from the shapes alone."""
    if min(S, C, P) <= 0:
        raise ValueError(f"S, C, P must be positive, got {S, C, P}")
    cpb = max(UNI_MIN_CELLS, math.ceil(C / max(num_sms, 1)))
    cpb = min(cpb, C)
    blocks = math.ceil(C / cpb)

    def per_step(reason):
        return LstmpSweepPlan(S, C, P, False, 0, 0, 0, 0, 0, reason)
    if cpb > UNI_MAX_CELLS:
        return per_step(
            f"C={C} needs {cpb} cells a block on {num_sms} SMs, more than "
            f"{UNI_MAX_CELLS}")
    # the deepest ring that fits, up to one stage a chunk of the state row:
    # each chunk waits on L2, so the more chunks in flight the better
    chunks = math.ceil(_round_up(P, 4) / UNI_K_CHUNK)
    for stages in range(min(UNI_MAX_STAGES, max(2, chunks)), 1, -1):
        fwd = _uni_smem(S, C, P, cpb, stages, False)
        bwd = _uni_smem(S, C, P, cpb, stages, True)
        if max(fwd, bwd) <= SMEM_LIMIT:
            return LstmpSweepPlan(S, C, P, True, blocks, cpb, stages, fwd,
                                  bwd)
    return per_step(
        f"(S, C, P) = {S, C, P} needs {max(fwd, bwd)} bytes of shared "
        f"memory a block, more than {SMEM_LIMIT}")


# -- the LSTMP inference sweeps ------------------------------------------------
#
# One launch a call, one or two directions (a BLSTMP layer's) of
# ``blocks_per_dir`` blocks each, 256 threads a block.  The limits are
# csrc/lstmp_forward.cu's kFwdThreads, kFewMaxStreams, kFwdMaxCells and
# kBarWords; FWD_MIN_CELLS is the plan's own choice: a block has 8 warps and
# the few-stream sweep gives a cell to a warp, so fewer cells a block would
# only add blocks to the barrier.

FWD_THREADS = 256
FEW_MAX_STREAMS = 16      # streams the few-stream sweep sums in one pass
FEW_TAG_STREAMS = 4       # most streams handed off by tagged values
FWD_MAX_CELLS = 16        # cells a block may own
FWD_MIN_CELLS = 8         # cells a block owns at least (one a warp)
BAR_WORDS = 64            # scratch words of the directions' barrier counters

PER_STEP, FEW, MANY = "per_step", "few", "many"
TAGS, BARRIER = "tags", "barrier"


def _few_tile(S: int) -> int:
    """Streams the few-stream sweep's register sums cover: the next power
    of 2."""
    return 1 << max(S - 1, 0).bit_length()


def _few_smem(S: int, C: int, P: int, cpb: int, ppb: int) -> int:
    """Bytes of a few-stream block's dynamic shared memory, all float32: the
    staged state rows r_prev [ST][P] and m [ST][C], W_r's gate rows of the owned cells
    [4 cpb][P], W_rm's rows of the owned columns [ppb][C], c of the owned
    cells [ST][cpb], r of the owned columns [ST][ppb] and the owned cells'
    peepholes [3][cpb] (ST = S rounded up to a power of 2); each region
    rounded up to 16 bytes."""
    st = _few_tile(S)
    regions = [4 * st * P, 4 * st * C, 4 * 4 * cpb * P, 4 * ppb * C,
               4 * st * cpb, 4 * st * ppb, 4 * 3 * cpb]
    return sum(_round_up(r, 16) for r in regions)


@dataclass(frozen=True)
class LstmpInferPlan:
    """How an inference call of ``directions`` directions runs.  ``regime``
    FEW or MANY: one cooperative launch of directions * ``blocks_per_dir``
    blocks, block b of a direction owning cells ``cells(b)`` (their four
    gate rows of W_r) and, in the few-stream sweep, projection columns
    ``cols(b)`` (their rows of W_rm; the many-stream sweep keeps the owned
    cells' columns of W_rm and a ring of ``stages`` chunks instead), within
    ``smem`` bytes of shared memory.  The few-stream sweep hands the step's
    state rows from their owners to every block by ``exchange``: TAGS (up to
    FEW_TAG_STREAMS streams: each value stored with the step's tag in one
    8-byte word, polled by its readers, no barrier) or BARRIER (the
    direction's counter barrier, then one cp.async group).  PER_STEP
    (``reason`` says why): two launches a frame and direction."""
    S: int
    C: int
    P: int
    directions: int
    regime: str
    blocks_per_dir: int
    cells_per_block: int
    cols_per_block: int
    stages: int
    smem: int
    reason: str = ""
    exchange: str = ""

    @property
    def persistent(self) -> bool:
        return self.regime != PER_STEP

    def cells(self, b: int) -> range:
        j0 = b * self.cells_per_block
        return range(min(j0, self.C), min(j0 + self.cells_per_block, self.C))

    def cols(self, b: int) -> range:
        p0 = b * self.cols_per_block
        return range(min(p0, self.P), min(p0 + self.cols_per_block, self.P))

    def kernel_args(self):
        """(regime, nbd, cpb, ppb, nstage, smem) as the C entry takes
        them: regime 1 the few-stream sweep with the barrier exchange, 3
        with the tag exchange, 2 the many-stream sweep, 0 (and zeros) the
        per-step kernels."""
        code = {PER_STEP: 0, FEW: 3 if self.exchange == TAGS else 1,
                MANY: 2}[self.regime]
        return (code, self.blocks_per_dir, self.cells_per_block,
                self.cols_per_block, self.stages, self.smem)

    def scratch_words(self) -> int:
        """float32 words of the call's scratch.  Both sweeps: the barrier
        counters; few streams: a direction's m row [S, C] and r row [S, P],
        two words an element (a value and its tag); many streams: direction b's state, then a direction's state row
        [S, pp] and partial slabs [blocks, S, pp].  The per-step kernels:
        m [S, C] and direction b's state.  Rows rounded up to 4 words."""
        sc, sp = _round_up(self.S * self.C, 4), _round_up(self.S * self.P, 4)
        state_b = (self.directions - 1) * (sc + sp)
        if self.regime == FEW:
            return BAR_WORDS + self.directions * 2 * (sc + sp)
        if self.regime == MANY:
            rows = (self.blocks_per_dir + 1) * self.S * _round_up(self.P, 4)
            return BAR_WORDS + state_b + self.directions * rows
        return sc + state_b


def lstmp_infer_per_step(S: int, C: int, P: int, directions: int,
                         reason: str) -> LstmpInferPlan:
    """The plan that takes the per-step kernels."""
    return LstmpInferPlan(S, C, P, directions, PER_STEP, 0, 0, 0, 0, 0,
                          reason)


def lstmp_infer_plan(S: int, C: int, P: int, directions: int,
                     num_sms: int) -> LstmpInferPlan:
    """The inference call's plan on a card of ``num_sms`` SMs.  Every
    direction's blocks are resident at once, one an SM: FWD_MIN_CELLS to
    FWD_MAX_CELLS cells a block over at most floor(num_sms / directions)
    blocks a direction (8 cells on 64 blocks at C = 512 for one direction
    or two; 8 on 100 at C = 800 for one).  At S <= FEW_MAX_STREAMS the
    few-stream sweep if its layout fits SMEM_LIMIT, else (and past 16
    streams) the many-stream sweep with the deepest ring (UNI_MAX_STAGES
    down to 2) that fits.

    Capacity: C <= FWD_MAX_CELLS * floor(num_sms / directions) (2112 for
    one direction on 132 SMs, 1056 for two) and the shared memory; at
    P = 512 the many-stream sweep holds one direction of every C <= 2112 at
    S <= 100 and of C <= 1848 at S = 128.  Past it the plan selects the
    per-step kernels (``regime`` PER_STEP), from the shapes alone."""
    if min(S, C, P) <= 0:
        raise ValueError(f"S, C, P must be positive, got {S, C, P}")
    if directions not in (1, 2):
        raise ValueError(f"1 or 2 directions, got {directions}")
    per_dir = num_sms // directions
    cpb = min(max(FWD_MIN_CELLS, math.ceil(C / max(per_dir, 1))), C)
    if per_dir < 1 or cpb > FWD_MAX_CELLS:
        return lstmp_infer_per_step(
            S, C, P, directions,
            f"C={C} needs {cpb} cells a block on {per_dir} SMs a direction, "
            f"more than {FWD_MAX_CELLS}")
    blocks = math.ceil(C / cpb)
    if S <= FEW_MAX_STREAMS:
        ppb = math.ceil(P / blocks)
        smem = _few_smem(S, C, P, cpb, ppb)
        if smem <= SMEM_LIMIT:
            return LstmpInferPlan(
                S, C, P, directions, FEW, blocks, cpb, ppb, 0, smem,
                exchange=TAGS if S <= FEW_TAG_STREAMS else BARRIER)
    chunks = math.ceil(_round_up(P, 4) / UNI_K_CHUNK)
    for stages in range(min(UNI_MAX_STAGES, max(2, chunks)), 1, -1):
        smem = _uni_smem(S, C, P, cpb, stages, False)
        if smem <= SMEM_LIMIT:
            return LstmpInferPlan(S, C, P, directions, MANY, blocks, cpb, 0,
                                  stages, smem)
    return lstmp_infer_per_step(
        S, C, P, directions,
        f"(S, C, P) = {S, C, P} needs {smem} bytes of shared memory a "
        f"block, more than {SMEM_LIMIT}")


# -- the xg-fed BLSTMP pair ---------------------------------------------------
#
# bf16 products take the sweeps of :func:`sweep_plan` (xg_bf16); float32
# products the FMA sweeps of csrc/bilstmp_xg_train.cu, each direction on
# lstmp_sweep.cuh's layout (the UNI_* limits) with, in the backward, the
# seven per-(stream, cell) dbias / dpeep sums after it.

TENSOR_CORE, FMA = "tensor_core", "fma"


def _xg_fma_smem(S: int, C: int, P: int, cpb: int, stages: int,
                 backward: bool) -> int:
    """Bytes of an FMA sweep block's dynamic shared memory: the
    unidirectional layout (:func:`_uni_smem`), plus in the backward the
    float32 sums [7][S][cpb]."""
    sums = _round_up(4 * 7 * S * cpb, 16) if backward else 0
    return _uni_smem(S, C, P, cpb, stages, backward) + sums


@dataclass(frozen=True)
class XgSweepPlan:
    """How the xg-fed pair runs.  ``path`` TENSOR_CORE (bf16 products) or
    FMA (float32 products): each sweep is one cooperative launch of
    2 * ``blocks_per_dir`` blocks, block b of a direction owning cells
    ``cells(b)`` and, on the tensor-core sweeps, projection columns
    ``cols(b)``; rings of ``stages_fwd`` / ``stages_bwd`` chunks and
    ``smem_fwd`` / ``smem_bwd`` bytes of shared memory.  PER_STEP
    (``reason`` says why): two launches a frame each way."""
    S: int
    C: int
    P: int
    mxu_bf16: bool
    path: str
    blocks_per_dir: int
    cells_per_block: int
    cols_per_block: int
    stages_fwd: int
    stages_bwd: int
    smem_fwd: int
    smem_bwd: int
    reason: str = ""

    @property
    def persistent(self) -> bool:
        return self.path != PER_STEP

    def cells(self, b: int) -> range:
        j0 = b * self.cells_per_block
        return range(min(j0, self.C), min(j0 + self.cells_per_block, self.C))

    def cols(self, b: int) -> range:
        p0 = b * self.cols_per_block
        return range(min(p0, self.P), min(p0 + self.cols_per_block, self.P))

    def kernel_args(self, backward: bool):
        """(nbd, cpb, ppb, stages, smem) as the sweeps' C entries take
        them."""
        return (self.blocks_per_dir, self.cells_per_block,
                self.cols_per_block,
                self.stages_bwd if backward else self.stages_fwd,
                self.smem_bwd if backward else self.smem_fwd)

    def row_width(self) -> int:
        """Columns of a scratch state row: P rounded up to 16 (bf16 rows
        of the tensor-core sweeps) or to 4 (float32 rows of the FMA
        sweeps)."""
        return _round_up(self.P, 16 if self.path == TENSOR_CORE else 4)


def bilstmp_xg_per_step(S: int, C: int, P: int, mxu_bf16: bool,
                        reason: str) -> XgSweepPlan:
    """The plan that takes the per-step kernels."""
    return XgSweepPlan(S, C, P, bool(mxu_bf16), PER_STEP, 0, 0, 0, 0, 0, 0,
                       0, reason)


def bilstmp_xg_plan(S: int, C: int, P: int, num_sms: int,
                    mxu_bf16: bool) -> XgSweepPlan:
    """The xg-fed pair's plan on a card of ``num_sms`` SMs, from the shapes
    alone.

    bf16 products: the tensor-core sweeps, laid out by :func:`sweep_plan`
    with the bf16 xg prefetch; within its capacity (C <= 1056 on 132 SMs,
    every C <= 1024, P <= 512 at S <= 128).  Float32 products: the FMA
    sweeps, UNI_MIN_CELLS to UNI_MAX_CELLS cells a block over at most
    floor(num_sms / 2) blocks a direction (8 cells on 64 blocks at
    C = 512), each sweep with the deepest ring (up to one stage a chunk of
    the state row, UNI_MAX_STAGES at most, 2 at least) that fits
    SMEM_LIMIT; capacity C <= UNI_MAX_CELLS * floor(num_sms / 2) and the
    shared memory.  Past either capacity the per-step kernels
    (``path`` PER_STEP), never an error."""
    if min(S, C, P) <= 0:
        raise ValueError(f"S, C, P must be positive, got {S, C, P}")

    def per_step(reason):
        return bilstmp_xg_per_step(S, C, P, mxu_bf16, reason)
    if mxu_bf16:
        try:
            sp = sweep_plan(S, C, P, num_sms, xg_bf16=True)
        except ValueError as err:
            return per_step(str(err))
        return XgSweepPlan(S, C, P, True, TENSOR_CORE, sp.blocks_per_dir,
                           sp.cells_per_block, sp.cols_per_block,
                           sp.stages_fwd, sp.stages_bwd, sp.smem_fwd,
                           sp.smem_bwd)
    per_dir = num_sms // 2
    cpb = min(max(UNI_MIN_CELLS, math.ceil(C / max(per_dir, 1))), C)
    if per_dir < 1 or cpb > UNI_MAX_CELLS:
        return per_step(f"C={C} needs {cpb} cells a block on {per_dir} SMs "
                        f"a direction, more than {UNI_MAX_CELLS}")
    chunks = math.ceil(_round_up(P, 4) / UNI_K_CHUNK)
    fits = []
    for backward in (False, True):
        for stages in range(min(UNI_MAX_STAGES, max(2, chunks)), 1, -1):
            smem = _xg_fma_smem(S, C, P, cpb, stages, backward)
            if smem <= SMEM_LIMIT:
                fits.append((stages, smem))
                break
        else:
            kind = "backward" if backward else "forward"
            return per_step(
                f"(S, C, P) = {S, C, P}: the {kind} sweep needs "
                f"{_xg_fma_smem(S, C, P, cpb, 2, backward)} bytes of shared "
                f"memory a block, more than {SMEM_LIMIT}")
    (sf, mf), (sb, mb) = fits
    return XgSweepPlan(S, C, P, False, FMA, math.ceil(C / cpb), cpb, 0, sf,
                       sb, mf, mb)
