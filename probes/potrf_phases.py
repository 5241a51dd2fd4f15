"""Where one blocked potrf problem spends its cycles, phase by phase, on
the card.

    python3 probes/potrf_phases.py

Copies capital_tpu_torch/ops/csrc under build/probes/potrf_phases/, puts a
clock64() stamp of block 0's thread 0 after each barrier of the potrf
kernel (the load and scan; per panel p: the diagonal block, the rows
below, the trailing update; the store) into a device array, builds it for
each panel width, runs 8 x 128 and 8192 x 128 f32, and prints one JSON
line per (width, batch): cycles since the kernel's start at each stamp
(slot 1 the load, 3 + 3p, 4 + 3p and 5 + 3p panel p's steps, 60 the
store).
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from capital_tpu_torch.ops import _build, batched_small  # noqa: E402

SRC = "batched_small.cu"
STAMP = '''
__device__ long long g_cyc[64];
#define PT(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) g_cyc[i] = clock64(); } while (0)
'''
#: (file, anchor, text inserted after it)
STAMPS = (
    ("batched_small.cuh", '#include "common.cuh"\n', STAMP),
    ("batched_small.cuh", "    if (__syncthreads_or(bad)) return -1;\n", "    PT(3 + 3 * (k0 / NB));\n"),
    ("batched_small.cuh", "    if (__syncthreads_or(chol_panel_row(S, ld, n, k0, sq))) return -1;\n",
     "    PT(4 + 3 * (k0 / NB));\n"),
    ("batched_small.cuh", "    chol_trailing(S, ld, n, k0);\n    __syncthreads();\n", "    PT(5 + 3 * (k0 / NB));\n"),
    (SRC, "  const long long off = (long long)blockIdx.x * n * n;\n", "  PT(0);\n"),
    (SRC, "  const bool finite = !__syncthreads_or(load_rows(S, ld, A + off, n));\n", "  PT(1);\n"),
    (SRC, "  store_factor(R + off, S, ld, n, upper);\n", "  __syncthreads();\n  PT(60);\n"),
)
WIDTHS = (16, 32)


def instrumented(root: Path, nb: int) -> tuple[subprocess.Popen, Path]:
    csrc = root / f"nb{nb}" / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    edits = [(name, anchor, anchor + text) for name, anchor, text in STAMPS]
    edits.append(("batched_small.cuh", "constexpr int NB = 16;", f"constexpr int NB = {nb};"))
    for name, old, new in edits:
        f = csrc / name
        s = f.read_text()
        assert s.count(old) == 1, old
        f.write_text(s.replace(old, new))
    with open(csrc / SRC, "a") as f:
        f.write('\nextern "C" int probe_cycles(long long* out) '
                '{ return (int)cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc)); }\n')
    lib = root / f"nb{nb}" / "batched_small.so"
    cmd = [_build.nvcc(), *_build.FLAGS, "-o", str(lib), str(csrc / SRC)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def main() -> int:
    if not torch.cuda.is_available():
        print("potrf_phases: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _build.build()
    tree = _build._STATE
    root = _build.build_dir().parent / "probes" / "potrf_phases"
    shutil.rmtree(root, ignore_errors=True)
    procs = {nb: instrumented(root, nb) for nb in WIDTHS}
    states = {}
    for nb, (p, lib) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(log[-3000:])
            return 1
        st = _build._Kernels()
        st.libs = dict(tree.libs)
        st.libs[SRC] = ctypes.CDLL(str(lib))
        for fn, (src, argtypes) in _build.SIGNATURES.items():
            if src == SRC:
                f = getattr(st.libs[SRC], fn)
                f.argtypes, f.restype = argtypes, ctypes.c_int
        cyc = st.libs[SRC].probe_cycles
        cyc.argtypes, cyc.restype = [ctypes.c_void_p], ctypes.c_int
        states[nb] = (st, cyc)
    dev = torch.device("cuda")
    for batch in (8, 8192):
        g = torch.Generator(device=dev).manual_seed(1)
        X = torch.randn((batch, 128, 128), generator=g, device=dev)
        A = X @ X.mT / 128 + 3 * torch.eye(128, device=dev)
        for nb, (st, cyc) in states.items():
            _build._STATE = st
            for _ in range(3):
                batched_small.potrf(A)
            torch.cuda.synchronize()
            buf = np.zeros(64, dtype=np.int64)
            if cyc(buf.ctypes.data):
                return 1
            t = buf - buf[0]
            print(json.dumps({"nb": nb, "batch": batch,
                              "cycles_since_start": {int(i): int(t[i]) for i in range(64) if buf[i]}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
