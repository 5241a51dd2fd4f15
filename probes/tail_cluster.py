"""The fused cholinv tail (`hopper.fused_tail`) on both its routes
against the kernel it replaced, and the cluster route's sizes against each
other, on the card.

    python3 probes/tail_cluster.py

Builds the replaced kernel (`OLD_KERNEL`: one block runs chol_sweep and
then bwd_sweep of the identity in shared memory, n <= 169) from a copy of
capital_tpu_torch/ops/csrc under build/probes/tail_cluster/ beside the
tree's own build.  At n = 128 (bf16 and f32) it holds the block route to
the replaced kernel bit for bit (R, R⁻¹ and info) and times the replaced
kernel, the block route and the kernel's own column-sweep path
(`_sweep`), interleaved (v0 .. vN, vN .. v0), wall by CUDA events and
device time from a torch.profiler trace.  At n = 256, 384 and 512 it holds
every cluster size that takes the window (2, 4, 8 blocks) to the plain
version and to each other bit for bit, and times each, interleaved, beside
the column-sweep path in block 0 (the fault path).  One JSON line per
window and dtype.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from capital_tpu_torch.ops import _build, hopper  # noqa: E402

#: the fused_tail kernel the two routes replaced (its C entry renamed)
OLD_KERNEL = """#include "batched_small.cuh"

using namespace small;

constexpr size_t SMEM_MAX = 232448 - 1024;

template <typename T>
__global__ void __launch_bounds__(NT) fused_tail_kernel(const T* buf, long long ldb, T* rp, T* rip, long long ldr,
                                                        int* info, int n) {
  extern __shared__ float smem[];
  const int ld = odd_ld(n);
  float* S = smem;          // the symmetrised window, then L (R = Lᵀ) in its lower triangle
  float* Y = smem + n * ld;  // I, then R⁻¹
  for (int e = threadIdx.x; e < n * n; e += NT) {
    const int r = e / n, c = e - r * n;
    if (c >= r) {  // the upper half, read along rows, mirrored
      const float v = widen(buf[r * ldb + c]);
      S[r * ld + c] = v;
      S[c * ld + r] = v;
    }
    Y[e] = (r == c) ? 1.f : 0.f;
  }
  __syncthreads();
  const int inf = chol_sweep(S, ld, n);
  bwd_sweep(S, ld, false, Y, n, n, n);  // R·X = I, R = Lᵀ
  for (int e = threadIdx.x; e < n * n; e += NT) {
    const int r = e / n, c = e - r * n;
    const bool up = c >= r;
    rp[r * ldr + c] = Cast<T>::from(up ? S[c * ld + r] : 0.f);
    rip[r * ldr + c] = Cast<T>::from(up ? Y[e] : 0.f);
  }
  if (threadIdx.x == 0) *info = inf;
}

template <typename T>
static int launch(const void* buf, long long ldb, void* rp, void* rip, long long ldr, void* info, int n,
                  void* stream) {
  const size_t smem = sizeof(float) * ((size_t)n * odd_ld(n) + (size_t)n * n);
  if (smem > SMEM_MAX) return -1;
  static const cudaError_t attr =
      cudaFuncSetAttribute(fused_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  fused_tail_kernel<T><<<1, NT, smem, (cudaStream_t)stream>>>((const T*)buf, ldb, (T*)rp, (T*)rip, ldr, (int*)info,
                                                               n);
  return (int)cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 = launched), -1 for arguments
// the kernel does not take.  buf, rp and rip point at the windows' first
// element; rp and rip share the leading dimension ldr.
extern "C" int probe_old_fused_tail(int dtype, const void* buf, long long ldb, void* rp, void* rip, long long ldr,
                                  void* info, int n, void* stream) {
  if (n < 1) return -1;
  if (dtype == DT_F32) return launch<float>(buf, ldb, rp, rip, ldr, info, n, stream);
  if (dtype == DT_BF16) return launch<bf16>(buf, ldb, rp, rip, ldr, info, n, stream);
  return -1;
}
"""


def build_old(root: Path):
    csrc = root / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    (csrc / "fused_tail.cu").write_text(OLD_KERNEL)
    lib = root / "old_fused_tail.so"
    p = subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(lib), str(csrc / "fused_tail.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"old fused_tail: nvcc failed\n{(p.stdout + p.stderr)[-3000:]}")
    fn = ctypes.CDLL(str(lib)).probe_old_fused_tail
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes, fn.restype = [I, P, LL, P, P, LL, P, I, P], I
    ptxas = [ln.strip() for ln in (p.stdout + p.stderr).splitlines() if "registers" in ln or "spill" in ln]
    return fn, ptxas


def cluster(A, n, blocks, probe=False):
    """One cluster-route launch of the tree's kernel on `blocks` blocks
    (`capital_fused_tail`'s C entry, as hopper.fused_tail calls it): (R,
    R⁻¹, info), or None where `probe` asks and the entry refuses the size."""
    Rp, RIp = torch.zeros_like(A), torch.zeros_like(A)
    info = torch.empty((), dtype=torch.int32, device="cuda")
    scratch = torch.empty(2 * n * n, dtype=torch.float32, device="cuda")
    rc = _build.entry("capital_fused_tail")(
        hopper._DTYPE_CODE[A.dtype], A.data_ptr(), A.stride(0), Rp.data_ptr(), RIp.data_ptr(), Rp.stride(0),
        info.data_ptr(), scratch.data_ptr(), n, blocks, 0, hopper._stream())
    if probe and rc == -1:
        return None
    assert rc == 0, (n, blocks, rc)
    return Rp, RIp, info


def window(n, dtype, seed):
    A = chip_smoke.spd_hash(n, torch.float32, salt=seed, device="cuda")
    return torch.triu(A).to(dtype)


def main() -> int:
    if not torch.cuda.is_available():
        print("tail_cluster: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    root = _build.build_dir().parent / "probes" / "tail_cluster"
    shutil.rmtree(root, ignore_errors=True)
    _build.build()
    old, ptxas = build_old(root)
    print(json.dumps({"old_ptxas": ptxas, "tree_ptxas": [
        ln.strip() for ln in _build.build_logs().get("fused_tail.cu", "").splitlines()
        if "registers" in ln or "spill" in ln]}), flush=True)
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        n = 128
        A = window(n, dtype, 3)
        outs = {}

        def run_old():
            Rp, RIp = torch.zeros_like(A), torch.zeros_like(A)
            info = torch.empty((), dtype=torch.int32, device="cuda")
            rc = old(hopper._DTYPE_CODE[dtype], A.data_ptr(), n, Rp.data_ptr(), RIp.data_ptr(), n,
                     info.data_ptr(), n, hopper._stream())
            assert rc == 0, rc
            return Rp, RIp, info

        variants = {
            "old": run_old,
            "block": lambda: hopper.fused_tail(A, torch.zeros_like(A), torch.zeros_like(A), off=0, n=n, dest=0),
            "sweep": lambda: hopper.fused_tail(A, torch.zeros_like(A), torch.zeros_like(A), off=0, n=n, dest=0,
                                               _sweep=True),
        }
        for name, fn in variants.items():
            outs[name] = fn()
        torch.cuda.synchronize()
        same = all(torch.equal(outs["old"][i], outs[v][i]) for v in ("block", "sweep") for i in range(3))
        ok &= same
        names = list(variants)
        ms = {v: [] for v in names}
        for v in names + names[::-1]:
            ms[v].append(chip_smoke.time_ms(variants[v], 50))
        dev = {v: chip_smoke.device_ms(variants[v], 20) for v in names}
        print(json.dumps({"window": n, "dtype": str(dtype), "bitwise_old_block_sweep": same,
                          "ms": {v: sum(t) / len(t) for v, t in ms.items()}, "runs": ms,
                          "device_ms": dev}), flush=True)
        for n in hopper.TAIL_CLUSTER_WINDOWS:
            A = window(n, dtype, n)
            # every cluster size the kernel takes for this window (its C
            # entry refuses the others with -1), launched past the wrapper,
            # which always takes hopper.TAIL_CLUSTER_BLOCKS[n]
            variants = {}
            for b in (2, 4, 8):
                if cluster(A, n, b, probe=True) is not None:
                    variants[f"cluster{b}"] = (lambda b=b: cluster(A, n, b))
            variants["sweep"] = lambda: hopper.fused_tail(A, torch.zeros_like(A), torch.zeros_like(A), off=0,
                                                          n=n, dest=0, _sweep=True)
            outs = {v: fn() for v, fn in variants.items()}
            Rq, RIq, iq = hopper.fused_tail_plain(A, torch.zeros_like(A), torch.zeros_like(A), off=0, n=n,
                                                  dest=0)
            torch.cuda.synchronize()
            ref = outs["sweep"]
            same = all(torch.equal(ref[i], o[i]) for o in outs.values() for i in range(3))
            err = max(chip_smoke.check_close("tail R", ref[0], Rq, dtype),
                      chip_smoke.check_close("tail R^-1", ref[1], RIq, dtype))
            ok &= same and int(iq) == 0
            names = list(variants)
            ms = {v: [] for v in names}
            for v in names + names[::-1]:
                ms[v].append(chip_smoke.time_ms(variants[v], 3 if v == "sweep" else 30))
            dev = {v: chip_smoke.device_ms(variants[v], 10) for v in names if v != "sweep"}
            print(json.dumps({"window": n, "dtype": str(dtype), "bitwise_all_sizes_and_sweep": same,
                              "max_abs_err_vs_plain": err, "ms": {v: sum(t) / len(t) for v, t in ms.items()},
                              "runs": ms, "device_ms": dev}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
