"""Build and load the port's CUDA kernels (ops/csrc/*.cu).

Each source compiles with `nvcc` for `sm_90a` into its own shared library
with a plain C interface, loaded with `ctypes` — no PyTorch headers, so a
build takes seconds.  All sources compile in parallel, one `nvcc` process
each, at the first launch of any kernel (or an explicit `build()`), into
`build/capital_tpu_torch/` beside the package.  A library's file name
carries a hash of its source, the shared headers and the flags, so an edited
source rebuilds and a stale library is never loaded.

Nothing here runs at import: the CPU test machine has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("tri_matmul.cu", "transpose.cu", "zeros_dead.cu", "qr_fused.cu", "batched_small.cu",
           "write_diag.cu", "fused_tail.cu", "tsqr.cu", "blocktri_small.cu", "update_small.cu",
           "sched_matmul.cu")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_D = ctypes.c_double
#: C signatures of the exported entry points (all return cudaError_t as int)
SIGNATURES = {
    "capital_tri_matmul": (
        "tri_matmul.cu",
        [_I, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _D, _D, _I, _I, _I,
         _I, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "capital_transpose": ("transpose.cu", [_I, _I, _P, _LL, _P, _LL, _I, _I, _I, _P]),
    "capital_transpose_pair": (
        "transpose.cu", [_I, _I, _P, _P, _LL, _P, _P, _LL, _I, _P],
    ),
    "capital_zeros_dead": (
        "zeros_dead.cu",
        [_P, _LL, _LL, _I, _I, _I, ctypes.POINTER(_LL), _I, _P],
    ),
    "capital_gram_blocked": ("qr_fused.cu", [_I, _P, _LL, _LL, _I, _I, _P, _P, _I, _P]),
    "capital_scale_blocked": ("qr_fused.cu", [_I, _P, _LL, _P, _LL, _P, _LL, _LL, _I, _P]),
    "capital_scale_gram": (
        "qr_fused.cu", [_I, _P, _LL, _P, _LL, _P, _LL, _LL, _I, _I, _P, _P, _I, _P],
    ),
    "capital_small_potrf": ("batched_small.cu", [_I, _P, _P, _P, _I, _I, _I, _P]),
    "capital_small_potrs": ("batched_small.cu", [_I, _P, _P, _P, _I, _I, _I, _I, _P]),
    "capital_small_posv": ("batched_small.cu", [_I, _P, _P, _P, _P, _I, _I, _I, _P]),
    "capital_small_lstsq": ("batched_small.cu", [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "capital_small_trsm": ("batched_small.cu", [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "capital_write_diag": ("write_diag.cu", [_I, _I, _P, _P, _LL, _I, _I, _I, _P]),
    "capital_fused_tail": ("fused_tail.cu", [_I, _P, _LL, _P, _P, _LL, _P, _P, _I, _I, _I, _P]),
    "capital_tsqr_panel": ("tsqr.cu", [_I, _P, _P, _P, _I, _I, _I, _P]),
    "capital_bt_fused_forward": (
        "blocktri_small.cu", [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "capital_bt_factor": ("blocktri_small.cu", [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "capital_bt_forward_solve": (
        "blocktri_small.cu", [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "capital_bt_solve_backward": (
        "blocktri_small.cu", [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "capital_up_sweep": ("update_small.cu", [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _P]),
    "capital_sched_matmul": (
        "sched_matmul.cu", [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
}


def build_dir() -> Path:
    """`build/capital_tpu_torch/` at the root of the checkout."""
    return CSRC.parents[2] / "build" / "capital_tpu_torch"


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    /usr/local/cuda/bin/nvcc."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / src, *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return build_dir() / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def sources_hash() -> str:
    """A hash of every kernel source, the shared headers and the flags:
    what a build in `build_dir()` was made from (the serve tier's warm-up
    manifest keys its fingerprint on it)."""
    h = hashlib.sha256()
    for part in (*(CSRC / s for s in SOURCES), *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


class _Kernels:
    """The loaded libraries and how long their build took."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.libs: dict[str, ctypes.CDLL] = {}
        self.build_seconds: float | None = None
        self.logs: dict[str, str] = {}
        #: resolved entry points, by name (argtypes set once, in `build`)
        self.fns: dict[str, ctypes._CFuncPtr] = {}


_STATE = _Kernels()


def build() -> float:
    """Compile every missing library (all in parallel), load them all, and
    return the seconds spent.  Raises with nvcc's output on failure."""
    with _STATE.lock:
        if _STATE.libs:
            return _STATE.build_seconds or 0.0
        t0 = time.perf_counter()
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        procs = {}
        for src in SOURCES:
            target = _lib_path(src)
            if target.is_file():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs[src] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp, target,
            )
        failed = []
        for src, (proc, tmp, target) in procs.items():
            log, _ = proc.communicate()
            _STATE.logs[src] = log
            (out / f"{Path(src).stem}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{src} (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, target)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        libs = {src: ctypes.CDLL(str(_lib_path(src))) for src in SOURCES}
        for fn, (src, argtypes) in SIGNATURES.items():
            f = getattr(libs[src], fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _STATE.libs = libs
        _STATE.build_seconds = time.perf_counter() - t0
        return _STATE.build_seconds


def entry(name: str):
    """The ctypes function `name` (argtypes declared), building the libraries
    on first use.  Resolved once: a launch pays one dict lookup here."""
    fn = _STATE.fns.get(name)
    if fn is None:
        if not _STATE.libs:
            build()
        fn = _STATE.fns[name] = getattr(_STATE.libs[SIGNATURES[name][0]], name)
    return fn


def build_logs() -> dict[str, str]:
    """nvcc's output (ptxas register and shared-memory use) per source, for
    the sources compiled by this process."""
    return dict(_STATE.logs)
