"""The blocked batched potrf against its panel width and against the column
sweep it replaced, on the card.

    python3 probes/potrf_nb.py

Builds copies of capital_tpu_torch/ops/csrc under build/probes/potrf_nb/
beside the tree's own build: 'nb16' is the tree's batched_small.cu (panel
width 16), 'nb32' sets the panel width `NB` in batched_small.cuh to 32
('nb32 3/SM' also asks the compiler for registers that fit three blocks an
SM), and 'sweep' puts back the
kernel the blocked factor replaced (`SWEEP_KERNEL`: one column sweep a
problem in an odd-leading-dimension tile).  Every variant is held to the plain version
(f32 and bf16, both uplo, n in `CHECK_N`, and `info` over NaN / -inf /
negative-pivot faults and an overflow born in an update at n = 40), then
8 x 128 and 8192 x 128 f32 are timed on every variant, interleaved
(v0 .. vN, vN .. v0), beside torch.linalg.cholesky_ex.  One JSON line per
variant, its ptxas register line first.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from capital_tpu_torch.ops import _build, batched_small  # noqa: E402

#: the potrf kernel and C entry the blocked factor replaced (one column sweep)
SWEEP_KERNEL = '''template <typename T>
__global__ void __launch_bounds__(NT) potrf_kernel(const T* A, T* R, int* info, int n, int upper) {
  extern __shared__ float smem[];
  const int ld = odd_ld(n);
  const long long off = (long long)blockIdx.x * n * n;
  for (int e = threadIdx.x; e < n * n; e += NT) {
    const int r = e / n, c = e - r * n;
    smem[r * ld + c] = widen(A[off + e]);
  }
  __syncthreads();
  const int inf = chol_sweep(smem, ld, n);
  T* r = R + off;
  for (int e = threadIdx.x; e < n * n; e += NT) {
    const int i = e / n, c = e - i * n;
    float v;
    if (upper) v = (c >= i) ? smem[c * ld + i] : 0.f;
    else v = (c <= i) ? smem[i * ld + c] : 0.f;
    r[e] = Cast<T>::from(v);
  }
  if (threadIdx.x == 0) info[blockIdx.x] = inf;
}

'''
SWEEP_ENTRY = '''extern "C" int capital_small_potrf(int dtype, const void* A, void* R, void* info, int batch, int n,
                                   int upper, void* stream) {
  if (n < 1) return -1;
  const size_t smem = sizeof(float) * (size_t)n * odd_ld(n);
  if (dtype == DT_F32)
    return run<potrf_kernel<float>>(batch, smem, stream, (const float*)A, (float*)R, (int*)info, n, upper);
  if (dtype == DT_BF16)
    return run<potrf_kernel<bf16>>(batch, smem, stream, (const bf16*)A, (bf16*)R, (int*)info, n, upper);
  return -1;
}

'''
SRC = "batched_small.cu"
LB3 = (SRC, "__launch_bounds__(NT) potrf_kernel", "__launch_bounds__(NT, 3) potrf_kernel")
NB32 = ("batched_small.cuh", "constexpr int NB = 16;", "constexpr int NB = 32;")
#: each variant: its text replacements, (file in csrc, old, new)
VARIANTS = {"nb16": (), "nb32": (NB32,), "nb32 3/SM": (NB32, LB3), "sweep": ()}
CHECK_N = (1, 7, 16, 31, 33, 64, 100, 128, 129, 240)


def between(s: str, start: str, stop: str) -> tuple[int, int]:
    i = s.index(start)
    return i, s.index(stop, i)


def sweep_source(text: str) -> str:
    """batched_small.cu with the blocked potrf kernel and entry replaced by
    the column-sweep ones."""
    i, j = between(text, "// One problem a block:",
                   "template <typename T>\n__global__ void __launch_bounds__(NT) potrs_kernel")
    text = text[:i] + SWEEP_KERNEL + text[j:]
    i, j = between(text, "// The potrf tile's leading dimension", 'extern "C" int capital_small_potrs')
    return text[:i] + SWEEP_ENTRY + text[j:]


def build_variants(root: Path) -> dict:
    """The tree's build, then each variant's batched_small.cu compiled in
    parallel; returns each variant's `_build._Kernels` (the other sources
    shared with the tree's)."""
    _build.build()
    tree = _build._STATE
    states, procs = {}, {}
    for name, subs in VARIANTS.items():
        d = root / name.replace(" ", "_").replace("/", "")
        csrc = d / "capital_tpu_torch/ops/csrc"
        shutil.copytree(_build.CSRC, csrc)
        if name == "sweep":
            (csrc / SRC).write_text(sweep_source((csrc / SRC).read_text()))
        for file, old, new in subs:
            text = (csrc / file).read_text()
            assert text.count(old) == 1, old
            (csrc / file).write_text(text.replace(old, new))
        lib = d / "batched_small.so"
        cmd = [_build.nvcc(), *_build.FLAGS, "-o", str(lib), str(csrc / SRC)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    for name, (p, lib) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        st = _build._Kernels()
        st.libs = dict(tree.libs)
        st.libs[SRC] = ctypes.CDLL(str(lib))
        for fn, (src, argtypes) in _build.SIGNATURES.items():
            if src == SRC:
                f = getattr(st.libs[SRC], fn)
                f.argtypes, f.restype = argtypes, ctypes.c_int
        st.logs = {SRC: log}
        states[name] = st
    for name, st in states.items():
        log = st.logs[SRC]
        i = log.find("Function properties for _Z12potrf_kernelIf")
        regs = [ln.strip() for ln in log[i:].splitlines()[1:3]]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    return states


def spd(batch: int, n: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((batch, n, n), generator=g, device=dev)
    return X @ X.mT / n + 3.0 * torch.eye(n, device=dev)


def faulted(dev) -> torch.Tensor:
    """n = 40 problems, one fault each (the CPU tests' cases), and one clean."""
    n = 40
    base = spd(1, n, 5, dev)[0]
    cases = [(0, 0, float("nan")), (5, 5, float("inf")), (0, 7, float("nan")), (9, 3, -float("inf")),
             (33, 30, float("nan")), (35, 12, float("inf")), (38, 36, float("nan")), (2, 37, float("nan")),
             (20, 31, -float("inf"))]
    A = base.repeat(len(cases) + 4, 1, 1)
    for p, (i, j, v) in enumerate(cases):
        A[p, i, j] = v
    A[len(cases), 3, 3] = -1.0
    A[len(cases) + 1, 36, 36] = -50.0
    # finite, but L[35][2]·L[35][2] overflows in the deferred trailing update
    for i in (35, 37):
        A[len(cases) + 2, i, 2] = A[len(cases) + 2, 2, i] = 1e20
    return A


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("potrf_nb: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    root = _build.build_dir().parent / "probes" / "potrf_nb"
    shutil.rmtree(root, ignore_errors=True)
    states = build_variants(root)
    dev = torch.device("cuda")
    ok = True
    for name, st in states.items():
        _build._STATE = st
        worst, infos = 0.0, True
        for n in CHECK_N:
            A = spd(3, n, n, dev)
            for dt in (torch.float32, torch.bfloat16):
                for uplo in ("U", "L"):
                    R, info = batched_small.potrf(A.to(dt), uplo=uplo)
                    Rp, ip = batched_small.potrf_plain(A.to(dt), uplo=uplo)
                    err = (R.double() - Rp.double()).abs()
                    tol = 1e-5 * float(Rp.double().abs().max()) + (2.0**-7 * Rp.double().abs()
                                                                   if dt == torch.bfloat16 else 0.0)
                    good = bool((err <= tol).all()) and torch.equal(info, ip) and torch.equal(R == 0, Rp == 0)
                    worst = max(worst, float(err.max()))
                    ok &= good
                    if not good:
                        print(json.dumps({"variant": name, "FAIL": n, "dtype": str(dt), "uplo": uplo}), flush=True)
        F = faulted(dev)
        for uplo in ("U", "L"):
            got, want = batched_small.potrf(F, uplo=uplo)[1], batched_small.potrf_plain(F, uplo=uplo)[1]
            infos &= torch.equal(got, want)
        ok &= infos
        print(json.dumps({"variant": name, "max_abs_err_vs_plain": worst, "fault_info_equal": infos,
                          "info": batched_small.potrf(F)[1].tolist()}), flush=True)
    if not ok:
        return 1
    cases = {"latency 8x128": spd(8, 128, 1, dev), "throughput 8192x128": spd(8192, 128, 2, dev)}
    for _ in range(100):  # the clocks up before the first timed variant
        torch.linalg.cholesky_ex(cases["throughput 8192x128"])
    res = {name: {c: [] for c in cases} for name in [*states, "cholesky_ex"]}
    order = [*states, "cholesky_ex"]
    for name in order + order[::-1]:
        for c, A in cases.items():
            iters = 20 if A.shape[0] < 100 else 5
            if name == "cholesky_ex":
                res[name][c].append(time_ms(lambda: torch.linalg.cholesky_ex(A, upper=True), iters))
            else:
                _build._STATE = states[name]
                res[name][c].append(time_ms(lambda: batched_small.potrf(A), iters))
    for name, r in res.items():
        print(json.dumps({"variant": name, **{c: sum(v) / len(v) for c, v in r.items()},
                          "runs": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
