"""Small-N batched solves on Hopper (counterpart of
capital_tpu/ops/batched_small.py): one launch per bucket batch, one block
per problem.

serve's bucketed requests (n <= 128) are latency-bound: a loop of library
calls pays one dispatch per problem and per phase, and round-trips each
factor through device memory between factor and solve.  These kernels put
the batch on the launch grid instead — block b owns problem b, so problems
never read each other's data (a NaN in one problem touches exactly its own
outputs and info: the serve fault-containment contract) — and fuse:

* ``posv``: the Cholesky factor and both triangular solves in one block
  (potrf's blocked factor, potrs' blocked solves); the factor lives in
  shared memory only.
* ``lstsq``: the whole CholeskyQR2 normal-equations pipeline (gram, two
  Cholesky sweeps, the R1⁻ᵀ·G·R1⁻¹ correction, the RHS sweeps and the
  back-substitution through R2·R1) in one block.
* ``potrf`` / ``potrs``: the unfused factor and solve (the `pallas_split`
  route, and the resident-factor solve); potrf runs a blocked factor.
* ``trsm``: one triangular solve, op(T)·X = B, for every uplo × trans, on
  potrs' blocked solves (no serve program calls it).

Each is a wrapper, a plain version and a launch counter, as in
ops/hopper.py.  The wrapper validates shapes, uplo and dtype (bf16 or f32;
f64 raises TypeError — the kernels compute in f32 and would downgrade it),
launches the hand-written kernel (ops/csrc/batched_small.cu) for CUDA
tensors and runs the plain version for CPU tensors.  The counters are
`hopper.KERNELS["small.*"]`.

The plain versions follow the JAX kernels' arithmetic: a column sweep of
rank-1 updates over the full matrix with the divisor of a bad pivot guarded
to 1.0, substitution sweeps that read only the live triangle, and the
in-program info of the LAPACK potrf convention (0 healthy, j for the first
bad pivot, n+1 for a clean diagonal with a non-finite entry).  Where the
JAX kernel's one-hot contractions spread a non-finite value (NaN·0 is NaN),
`sweeps.chol_plain` spreads it the same way, so `info` agrees exactly: a
non-finite anywhere in row i of the working matrix poisons the extracted
column's entry i, and the pivot is that column's entry j.  The CUDA sweep
(ops/csrc/batched_small.cuh) derives the same info from the entries it
keeps.  Identity problems and identity-tail pads solve exactly (every
product is 0·x or 1·x, every divisor 1.0), so bucket padding stays
invisible: zero right-hand sides solve to exact zeros with info 0.

The `block` knob (the JAX kernels' static column unroll) is validated and
changes nothing here.
"""

from __future__ import annotations

import torch

from capital_tpu_torch.ops import _build, hopper, sweeps
from capital_tpu_torch.utils import tracing

#: Largest bucket n the "auto" impl routes to these kernels (the JAX
#: package's value; the serve config can force either side).
SMALL_N_MAX = 128

IMPLS = ("auto", "vmap", "pallas", "pallas_split")

#: rows of [A | B] a stage of the lstsq kernel holds at most (csrc
#: LSTSQ_ROWS); fewer when a stage would hold more than 8 groups of 4
#: entries a thread of 256 (csrc lstsq_stage_rows)
LSTSQ_ROWS = 32

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def pick_block(n: int) -> int:
    """Default column-block unroll: largest power of two <= 8 dividing n."""
    for b in (8, 4, 2):
        if n % b == 0:
            return b
    return 1


def _resolve_block(n: int, block: int) -> int:
    b = block or pick_block(n)
    while n % b:
        b -= 1
    return max(b, 1)


def _potrf_ld(n: int) -> int:
    """Leading dimension of the potrf kernel's tile (csrc potrf_ld): round4(n)
    floats (16-byte rows), plus 4 when that makes it 4 mod 8 and still fits."""
    n4 = (n + 3) // 4 * 4
    ld = n4 if (n4 // 4) % 2 else n4 + 4
    return ld if 4 * n4 * ld <= hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE else n4


def _potrs_lds(n: int, k: int) -> tuple[int, int]:
    """The potrs kernel's tile strides (csrc potrs_lds): round4(n) for the
    factor and round4(k) for the right-hand sides, each plus 4 when that
    makes it 4 mod 8 and round4(n) rows of both still fit a block."""
    n4, k4 = (n + 3) // 4 * 4, (k + 3) // 4 * 4
    lp = n4 if (n4 // 4) % 2 else n4 + 4
    yp = k4 if (k4 // 4) % 2 else k4 + 4
    fit = (hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE) // 4 // n4
    ld = lp if lp + yp <= fit else n4
    return ld, yp if ld + yp <= fit else k4


def _lstsq_floats(n: int, k: int) -> int:
    """csrc lstsq_floats: the stage or G's copy, the G -> V -> G2 -> R tile,
    AᵀB and a panel of G2."""
    n4, k4 = (n + 3) // 4 * 4, (k + 3) // 4 * 4
    ld = n4 if (n4 // 4) % 2 else n4 + 4
    rows = max(1, min(LSTSQ_ROWS, 8 * 256 // ((n + 3) // 4 + (k + 3) // 4)))
    stage = 2 * rows * (-(-n // 32) * 32 + -(-k // 16) * 16)
    return max(n4 * ld, stage) + n4 * ld + n4 * k4 + 16 * n4


def smem_bytes(op: str, n: int, k: int) -> int:
    """Dynamic shared memory of one block of the `op` kernel for one problem
    of order n with k right-hand sides.  Every kernel keeps 16-byte rows:
    round4(n) rows of round4(n) floats, plus 4 when that is 0 mod 8
    (`_potrf_ld` for potrf, `_potrs_lds` for the solves).

    potrf              4·round4(n)·_potrf_ld(n)   (the working matrix)
    potrs, posv, trsm  4·round4(n)·(ld + ldy)     (A, then L and U = Lᵀ in
                                                   its two triangles, or
                                                   trsm's T in the one its
                                                   solve reads; the
                                                   right-hand sides;
                                                   `_potrs_lds`)
    lstsq              4·(max(tile, stage) + tile + round4(n)·round4(k)
                       + 16·round4(n))            (G's copy and R1 or the
                                                   [A|B] stage, the
                                                   G→V→G2→R2→R tile, AᵀB,
                                                   a 16-column panel of G2)
    with tile = round4(n)·ld and stage = 2·rows·(round32(n) + round16(k)),
    rows = min(LSTSQ_ROWS, 2048 // (ceil(n/4) + ceil(k/4))).
    """
    if op == "potrf":
        return 4 * ((n + 3) // 4 * 4) * _potrf_ld(n)
    if op in ("potrs", "posv", "trsm"):
        return 4 * ((n + 3) // 4 * 4) * sum(_potrs_lds(n, k))
    if op == "lstsq":
        return 4 * _lstsq_floats(n, k)
    raise ValueError(f"unknown batched_small op {op!r}")


def eligible(op: str, a_shape: tuple, b_shape: tuple | None, dtype, *, interpret: bool) -> bool:
    """Whether the kernel takes ONE problem of these BATCHED (batch, m, n) /
    (batch, n, k) shapes: its working set (`smem_bytes`) must fit the
    shared memory of one block, 232,448 bytes less a 1,024-byte reserve.
    m does not enter (lstsq streams A and B through a stage of at most
    LSTSQ_ROWS rows); the batch axis lives on the launch grid.  `op` is
    'posv' (also serve's inv as posv with k = n), 'potrs', 'trsm', 'lstsq'
    or 'potrf'; b_shape None means k = n.  A posv or inv bucket may run as
    potrf + potrs (`pallas_split`, the refinement loop); posv, potrs and
    trsm share one working set (`smem_bytes`), which is posv's envelope.

    Edges at f32 and bf16 alike (shared memory holds f32): n = 128 takes
    posv, potrs and trsm up to k = 324 and lstsq up to k = 172; n = 160
    takes posv up to k = 200; potrf takes n up to 240.  Every bucket the
    'auto' rule routes here (n <= 128, posv/inv with k <= n, lstsq with
    k <= n) is eligible, so 'auto' resolves as the JAX package does
    there.

    interpret=True (the operands lie on the CPU) answers True: the plain
    versions have no envelope, as the JAX kernels in interpret mode have
    none."""
    del dtype  # the working set is f32 whatever the storage dtype
    if interpret:
        return True
    n = a_shape[-1]
    k = b_shape[-1] if b_shape is not None else n
    return smem_bytes("posv" if op == "inv" else op, n, k) <= hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE


def dtype_capable(dtype) -> bool:
    """Whether the kernels serve this dtype without precision loss: they
    compute in f32, so f64 is out, even under a forced impl."""
    return dtype in _KERNEL_DTYPES


def default_impl(op: str, a_shape: tuple, b_shape: tuple | None, dtype, *, interpret: bool) -> str:
    """Resolve impl='auto' for one bucket from its BATCHED shapes: 'pallas'
    (the fused kernels) for posv/lstsq at n <= SMALL_N_MAX in bf16 or f32
    within the envelope (`eligible`), else 'vmap'.  f64 always takes
    vmap."""
    if op not in ("posv", "lstsq"):
        return "vmap"
    if not dtype_capable(dtype):
        return "vmap"
    if a_shape[-1] > SMALL_N_MAX:
        return "vmap"
    return ("pallas"
            if eligible(op, a_shape, b_shape, dtype, interpret=interpret)
            else "vmap")


# --------------------------------------------------------------------------
# argument handling
# --------------------------------------------------------------------------


def _check_batched(A, B=None, *, square=True, op="batched_small"):
    if A.ndim != 3 or (square and A.shape[1] != A.shape[2]):
        raise ValueError(
            f"{op}: operand batch must be (batch, n, n), got {tuple(A.shape)}"
        )
    if B is not None:
        if B.ndim != 3 or B.shape[0] != A.shape[0] or B.shape[1] != A.shape[1]:
            raise ValueError(
                f"{op}: RHS batch {tuple(B.shape)} does not ride operand batch "
                f"{tuple(A.shape)}"
            )


def _check_uplo(uplo: str) -> None:
    if uplo not in ("U", "L"):
        raise ValueError(f"uplo must be 'U' or 'L', got {uplo!r}")


def _check_dtype(op: str, *tensors) -> None:
    for t in tensors:
        if t.dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"{op}: takes bf16 or f32, got {t.dtype} (the kernels compute "
                "in f32; f64 takes the vmap route)"
            )
    if len({t.dtype for t in tensors}) > 1:
        raise TypeError(f"{op}: operands of one dtype, got {[t.dtype for t in tensors]}")


def _check_lstsq(A, B) -> None:
    _check_batched(A, B, square=False, op="batched lstsq")
    if A.shape[1] < A.shape[2]:
        raise ValueError(f"batched lstsq wants tall problems, got {tuple(A.shape[1:])}")
    _check_dtype("batched lstsq", A, B)


def _kernel_gate(op: str, n: int, k: int) -> None:
    need, have = smem_bytes(op, n, k), hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE
    if need > have:
        raise ValueError(
            f"batched {op}: one problem of order {n} with {k} right-hand sides "
            f"needs {need} bytes of shared memory, a block has {have}"
        )


def _launch(name: str, *args) -> None:
    rc = _build.entry("capital_small_" + name)(*args, hopper._stream())
    hopper._launched(rc, hopper.KERNELS["small." + name])


def potrf_plain(A, *, uplo: str = "U", block: int = 0, precision=None):
    """Plain PyTorch version of `potrf`."""
    del precision  # f32 is always IEEE f32 here
    _check_batched(A, op="batched potrf")
    _check_uplo(uplo)
    _check_dtype("batched potrf", A)
    _resolve_block(A.shape[-1], block)
    R, info = sweeps.chol_plain(A.float(), uplo)
    R = torch.triu(R) if uplo == "U" else torch.tril(R)
    return R.to(A.dtype), info


def potrs_plain(T, B, *, uplo: str = "U", block: int = 0, precision=None):
    """Plain PyTorch version of `potrs`."""
    del precision
    _check_batched(T, B, op="batched potrs")
    _check_uplo(uplo)
    _check_dtype("batched potrs", T, B)
    _resolve_block(T.shape[-1], block)
    t = T.float()
    y = sweeps.fwd_solve_plain(t, B.float(), from_upper=(uplo == "U"))
    return sweeps.bwd_solve_plain(t, y, from_upper=(uplo == "U")).to(B.dtype)


def posv_plain(A, B, *, uplo: str = "U", block: int = 0, precision=None):
    """Plain PyTorch version of `posv`."""
    del precision
    _check_batched(A, B, op="batched posv")
    _check_uplo(uplo)
    _check_dtype("batched posv", A, B)
    _resolve_block(A.shape[-1], block)
    R, info = sweeps.chol_plain(A.float(), uplo)
    y = sweeps.fwd_solve_plain(R, B.float(), from_upper=(uplo == "U"))
    x = sweeps.bwd_solve_plain(R, y, from_upper=(uplo == "U"))
    return x.to(B.dtype), info


def lstsq_plain(A, B, *, block: int = 0, precision=None):
    """Plain PyTorch version of `lstsq`."""
    del precision
    _check_lstsq(A, B)
    _resolve_block(A.shape[-1], block)
    a, b = A.float(), B.float()
    G = a.mT @ a
    C = a.mT @ b
    R1, i1 = sweeps.chol_plain(G, "U")
    V = sweeps.fwd_solve_plain(R1, G, from_upper=True)
    G2 = sweeps.rsolve_upper_plain(R1, V)
    R2, i2 = sweeps.chol_plain(G2, "U")
    t1 = sweeps.fwd_solve_plain(R1, C, from_upper=True)
    t2 = sweeps.fwd_solve_plain(R2, t1, from_upper=True)
    R = torch.triu(R2) @ torch.triu(R1)
    x = sweeps.bwd_solve_plain(R, t2, from_upper=True)
    return x.to(B.dtype), torch.maximum(i1, i2)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def potrf(A, *, uplo: str = "U", block: int = 0, precision: str | None = "highest"):
    """Batched Cholesky: (batch, n, n) symmetric SPD -> (R, info), R
    triangular per `uplo` with its dead triangle exactly zero, info (batch,)
    int32 in the potrf convention.  One launch (ops/csrc/batched_small.cu):
    the blocked factor (csrc chol_blocked: 16-column panels, the diagonal
    block in one warp's registers, 4 x 4 register tiles for the trailing
    update), bitwise the column sweep's factor; a problem whose input,
    pivots or factor show a fault is factored again by the column sweep in
    the same launch, so `info` is the reference's on every input."""
    _check_batched(A, op="batched potrf")
    _check_uplo(uplo)
    _check_dtype("batched potrf", A)
    _resolve_block(A.shape[-1], block)
    batch, n, _ = A.shape
    with tracing.scope("OP::batched_small"):
        tracing.emit(flops=batch * tracing.batched_chol_flops(n))
        if not hopper._on_card(A):
            return potrf_plain(A, uplo=uplo)
        _kernel_gate("potrf", n, n)
        A = A.contiguous()
        R = torch.empty_like(A)
        info = torch.empty(batch, dtype=torch.int32, device=A.device)
        if batch:
            _launch("potrf", hopper._DTYPE_CODE[A.dtype], A.data_ptr(), R.data_ptr(),
                    info.data_ptr(), batch, n, int(uplo == "U"))
    return R, info


def trsm_plain(T, B, *, uplo: str = "U", trans: bool = False, block: int = 0, precision=None):
    """Plain PyTorch version of `trsm`."""
    del precision
    _check_batched(T, B, op="batched trsm")
    _check_uplo(uplo)
    _check_dtype("batched trsm", T, B)
    _resolve_block(T.shape[-1], block)
    forward = (uplo == "L") ^ bool(trans)
    solve = sweeps.fwd_solve_plain if forward else sweeps.bwd_solve_plain
    return solve(T.float(), B.float(), from_upper=(uplo == "U")).to(B.dtype)


def trsm(T, B, *, uplo: str = "U", trans: bool = False, block: int = 0,
         precision: str | None = "highest"):
    """Batched triangular solve op(T)·X = B over (batch, n, n) factors and
    (batch, n, k) right-hand sides, op(T) = T or Tᵀ (trans): one launch,
    one block per problem on potrs' tile and blocked solves — forward
    (csrc fwd_blocked) when op(T) is lower ((uplo == 'L') xor trans), else
    backward (bwd_upper_blocked), each its column sweep's arithmetic in the
    sweep's order; only the live triangle of T is used.  X is a new
    tensor: the JAX kernel aliases it onto B, the port keeps B."""
    _check_batched(T, B, op="batched trsm")
    _check_uplo(uplo)
    _check_dtype("batched trsm", T, B)
    _resolve_block(T.shape[-1], block)
    batch, n, _ = T.shape
    k = B.shape[-1]
    forward = (uplo == "L") ^ bool(trans)
    with tracing.scope("OP::batched_small"):
        tracing.emit(flops=batch * tracing.batched_trsm_flops(n, k))
        if not hopper._on_card(T, B):
            return trsm_plain(T, B, uplo=uplo, trans=trans)
        _kernel_gate("trsm", n, k)
        T, B = T.contiguous(), B.contiguous()
        X = torch.empty_like(B)
        if batch and k:
            _launch("trsm", hopper._DTYPE_CODE[T.dtype], T.data_ptr(), B.data_ptr(),
                    X.data_ptr(), batch, n, k, int(uplo == "U"), int(forward))
    return X


def potrs(T, B, *, uplo: str = "U", block: int = 0, precision: str | None = "highest"):
    """Batched SPD solve from a ready factor (A = RᵀR for 'U', L·Lᵀ for 'L'):
    both triangular sweeps in one launch, the factor read once.  X is a new
    tensor; B is kept."""
    _check_batched(T, B, op="batched potrs")
    _check_uplo(uplo)
    _check_dtype("batched potrs", T, B)
    _resolve_block(T.shape[-1], block)
    batch, n, _ = T.shape
    k = B.shape[-1]
    with tracing.scope("OP::batched_small"):
        tracing.emit(flops=batch * 2 * tracing.batched_trsm_flops(n, k))
        if not hopper._on_card(T, B):
            return potrs_plain(T, B, uplo=uplo)
        _kernel_gate("potrs", n, k)
        T, B = T.contiguous(), B.contiguous()
        X = torch.empty_like(B)
        if batch and k:
            _launch("potrs", hopper._DTYPE_CODE[T.dtype], T.data_ptr(), B.data_ptr(),
                    X.data_ptr(), batch, n, k, int(uplo == "U"))
    return X


def posv(A, B, *, uplo: str = "U", block: int = 0, precision: str | None = "highest"):
    """FUSED batched SPD solve: factor and both triangular solves in one
    launch; the factor never exists in device memory.  The kernel runs
    potrf's blocked factor (csrc chol_blocked) and potrs' blocked solves on
    one 16-byte-row tile; a problem whose input or pivots show a fault is
    factored again by the column sweep in the same launch, so X and `info`
    are the column sweeps' bit for bit (and `potrs(potrf(A), B)`'s, on f32
    storage).  Returns (X, info): X (batch, n, k) a new tensor, info
    (batch,) int32."""
    _check_batched(A, B, op="batched posv")
    _check_uplo(uplo)
    _check_dtype("batched posv", A, B)
    _resolve_block(A.shape[-1], block)
    batch, n, _ = A.shape
    k = B.shape[-1]
    with tracing.scope("SV::fused_posv"):
        tracing.emit(flops=batch * tracing.fused_posv_flops(n, k))
        if not hopper._on_card(A, B):
            return posv_plain(A, B, uplo=uplo)
        _kernel_gate("posv", n, k)
        A, B = A.contiguous(), B.contiguous()
        X = torch.empty_like(B)
        info = torch.empty(batch, dtype=torch.int32, device=A.device)
        if batch:
            _launch("posv", hopper._DTYPE_CODE[A.dtype], A.data_ptr(), B.data_ptr(),
                    X.data_ptr(), info.data_ptr(), batch, n, k)
    return X, info


def lstsq(A, B, *, block: int = 0, precision: str | None = "highest"):
    """FUSED batched CholeskyQR2 least squares in one launch: G = AᵀA and
    C = AᵀB from A and B streamed once (accumulated in registers), then
    R1 = chol(G), G2 = R1⁻ᵀ·G·R1⁻¹, R2 = chol(G2),
    X = (R2·R1)⁻¹·R2⁻ᵀ·R1⁻ᵀ·C on (n, n) state in shared memory, with the
    blocked factor (csrc chol_blocked) and blocked triangular solves; a
    problem whose gram, G2 or factors show a fault runs the column sweeps
    in the same launch, so `info` is the reference's.  Returns (X, info):
    X (batch, n, k), info = max(info1, info2)."""
    _check_lstsq(A, B)
    _resolve_block(A.shape[-1], block)
    batch, m, n = A.shape
    k = B.shape[-1]
    with tracing.scope("SV::fused_lstsq"):
        tracing.emit(flops=batch * tracing.fused_lstsq_flops(m, n, k))
        if not hopper._on_card(A, B):
            return lstsq_plain(A, B)
        _kernel_gate("lstsq", n, k)
        A, B = A.contiguous(), B.contiguous()
        X = torch.empty((batch, n, k), dtype=B.dtype, device=B.device)
        info = torch.empty(batch, dtype=torch.int32, device=A.device)
        if batch:
            _launch("lstsq", hopper._DTYPE_CODE[A.dtype], A.data_ptr(), B.data_ptr(),
                    X.data_ptr(), info.data_ptr(), batch, m, n, k)
    return X, info
