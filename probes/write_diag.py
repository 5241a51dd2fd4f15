"""write_diag_blocks' 'vec' route against the kernel it replaced, on the card.

    python3 probes/write_diag.py [--skip-timing]

Builds, beside the tree's own build and in one process, under
build/probes/write_diag/: the replaced kernel (`REPLACED`: the one-element-
a-thread kernel of the first port, whole, its entry renamed
`capital_write_diag_replaced`) and the variants (`VARIANTS`: text edits of
a copy of the tree's write_diag.cu — streaming cache hints on the loads
(`__ldcs`), on the stores (`__stcs`) or both, loads that do not allocate in
L1 (`ld.global.nc.L1::no_allocate`), and 2 or 8 vectors a thread in flight
instead of 4).  Each is a shared library of its own, called through its C
entry.

Checks, every one bit for bit against the replaced kernel (the whole
NaN-filled buffer, NaN payloads included): every dtype pair (bf16 / f32 /
f64 in and out) at s in `CHECK_S`, three blocks, W holding NaN, ±inf, ±0,
subnormals and values that overflow or turn subnormal in a narrower out,
into out views at column offsets 0, 1 and 8 (aligned and not); the
wrapper (the rule's route), the tree's 'elem' and 'vec' routes through the
C entry (where 'vec' can take the operands) and every variant; then the
timed shapes.  Prints one JSON line per failed check and a count.

Then timings in turns (v0 .. vN, vN .. v0, `TURNS` readings of each;
medians): wall per call by CUDA events around 20 back-to-back calls
(`chip_smoke.time_ms`), device time per call by CUDA events around 20
calls queued behind a spin kernel (`chip_smoke.queued_ms`), and device
time from a trace that kept every launch (`chip_smoke.device_ms`, first
turn), for the parent's wrapper on the replaced kernel (`parent`), the
tree's wrapper (`tree`), both kernels through their C entries
(`replaced`, `tree_c`), each variant, `copy_` into the blocks view
(the library call) and, as the card's copy rate for the same bytes,
`copy_` of W into a contiguous stack of out's dtype (`copy_flat`), at
`TIMED`: the rectri flagship's write-back (96 x 512² bf16 into 49152²), the
f32 rectri cell's (16 x 512² f32 into 8192²), f32 W into bf16 at
96 x 512², and s = 100 bf16 (the 'elem' route).  W and the blocks stay
warm in the 50 MB L2 between calls as far as they fit, for every variant
alike.  Prints the ptxas lines of every build and the card's name and
power limit.
"""

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from capital_tpu_torch.ops import _build, hopper  # noqa: E402

SRC = "write_diag.cu"
#: the kernel the 'vec' route replaced, whole (its entry renamed)
REPLACED = r"""// write_diag_blocks: a (count, s, s) stack W onto the diagonal blocks
// out[i·s:(i+1)·s, i·s:(i+1)·s] of a square row-major buffer, in place,
// cast to out's dtype.  Every other element of out is left untouched.
//
// Replaces capital_tpu/ops/pallas_tpu.py:write_diag_blocks (:530, the
// pallas_call at :560), the rectri batched prefix's write-back
// (models/inverse.py, RT::batch_write).
//
// What bounds it on the card: bytes — W read once, count·s² elements of
// out written once, no arithmetic.  At the rectri flagship (96 blocks of
// 512² bf16 into a 49152² buffer) that is 100 MB, 0.030 ms at 3.35 TB/s.
// What the design does about it: blockIdx.y picks the block, blockIdx.x a
// band of ROWS rows; the threads of a block walk along a row, so reads of W
// and writes of out are both contiguous runs of s elements.  The TPU
// kernel's 128-lane block shape and its copy-chain fallback for other s do
// not carry over: any s works.

#include "common.cuh"

constexpr int ROWS = 8;
constexpr int THREADS = 256;

template <typename Tw, typename To>
__global__ void __launch_bounds__(THREADS) write_diag_kernel(const Tw* W, To* out, long long ldo, int s) {
  const long long b = blockIdx.y;
  const Tw* w = W + b * s * s;
  To* o = out + b * s * ldo + b * s;
  const int r1 = min(s, (int)(blockIdx.x + 1) * ROWS);
  for (int r = blockIdx.x * ROWS; r < r1; ++r) {
    for (int c = threadIdx.x; c < s; c += THREADS) o[r * ldo + c] = Cast<To>::from(w[(long long)r * s + c]);
  }
}

template <typename Tw, typename To>
static int launch(const void* W, void* out, long long ldo, int count, int s, void* stream) {
  const dim3 grid((s + ROWS - 1) / ROWS, count);
  write_diag_kernel<Tw, To><<<grid, THREADS, 0, (cudaStream_t)stream>>>((const Tw*)W, (To*)out, ldo, s);
  return (int)cudaGetLastError();
}

template <typename Tw>
static int by_out(int dt_out, const void* W, void* out, long long ldo, int count, int s, void* stream) {
  if (dt_out == DT_BF16) return launch<Tw, bf16>(W, out, ldo, count, s, stream);
  if (dt_out == DT_F32) return launch<Tw, float>(W, out, ldo, count, s, stream);
  if (dt_out == DT_F64) return launch<Tw, double>(W, out, ldo, count, s, stream);
  return -1;
}

// Returns the cudaError_t of the launch (0 = launched), -1 for arguments
// the kernel does not take.  W is a contiguous (count, s, s) stack; out a
// row-major buffer with leading dimension ldo.
extern "C" int capital_write_diag_replaced(int dt_w, int dt_out, const void* W, void* out, long long ldo, int count,
                                  int s, void* stream) {
  if (count < 1 || count > 65535 || s < 1) return -1;
  if (dt_w == DT_BF16) return by_out<bf16>(dt_out, W, out, ldo, count, s, stream);
  if (dt_w == DT_F32) return by_out<float>(dt_out, W, out, ldo, count, s, stream);
  if (dt_w == DT_F64) return by_out<double>(dt_out, W, out, ldo, count, s, stream);
  return -1;
}
"""
#: variants of the tree's source: (old text, new text) edits
VARIANTS = {
    "ldcs": [("return *reinterpret_cast<const uint4*>(p); }", "return __ldcs(reinterpret_cast<const uint4*>(p)); }")],
    "stcs": [("reinterpret_cast<uint4*>(p)[j] = reinterpret_cast<const uint4*>(y)[j];",
              "__stcs(reinterpret_cast<uint4*>(p) + j, reinterpret_cast<const uint4*>(y)[j]);"),
             ("*reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(y);",
              "__stcs(reinterpret_cast<uint2*>(p), *reinterpret_cast<const uint2*>(y));"),
             ("*reinterpret_cast<unsigned*>(p) = *reinterpret_cast<const unsigned*>(y);",
              "__stcs(reinterpret_cast<unsigned*>(p), *reinterpret_cast<const unsigned*>(y));")],
    "no_allocate": [("return *reinterpret_cast<const uint4*>(p); }",
                     "uint4 v; asm volatile(\"ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\" "
                     ": \"=r\"(v.x), \"=r\"(v.y), \"=r\"(v.z), \"=r\"(v.w) : \"l\"(p)); return v; }")],
    "unroll2": [("constexpr int VEC_UNROLL = 4;", "constexpr int VEC_UNROLL = 2;")],
    "unroll8": [("constexpr int VEC_UNROLL = 4;", "constexpr int VEC_UNROLL = 8;")],
}
VARIANTS["ldcs_stcs"] = VARIANTS["ldcs"] + VARIANTS["stcs"]
CHECK_S = (1, 7, 8, 16, 24, 40, 64, 100, 128, 256)
#: the timed cases (count, s, W dtype, out dtype): chip_smoke's
TIMED = chip_smoke.WRITE_DIAG_CASES
TURNS = 8
DTYPES = (torch.bfloat16, torch.float32, torch.float64)
BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32, torch.float64: torch.int64}


def ptxas_lines(log: str) -> list:
    keep = ("Compiling entry function", "registers", "spill")
    return [ln.replace("ptxas info    : ", "").strip() for ln in log.splitlines() if any(x in ln for x in keep)]


def build(root: Path) -> dict:
    """The C entry of every build: 'tree' (the tree's library), 'replaced'
    and each variant."""
    _build.build()
    log = _build.build_logs().get(SRC) or (_build.build_dir() / (Path(SRC).stem + ".log")).read_text()
    print(json.dumps({"variant": "tree", "ptxas": ptxas_lines(log)}), flush=True)
    procs = {}
    for name in ("replaced", *VARIANTS):
        csrc = root / name / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        text = REPLACED if name == "replaced" else (csrc / SRC).read_text()
        for a, b in VARIANTS.get(name, ()):
            assert text.count(a) == 1, (name, a[:60])
            text = text.replace(a, b)
        (csrc / SRC).write_text(text)
        lib = root / name / "write_diag.so"
        cmd = [_build.nvcc(), *_build.FLAGS, "-o", str(lib), str(csrc / SRC)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    argtypes = _build.SIGNATURES["capital_write_diag"][1]
    entries = {"tree": _build.entry("capital_write_diag")}
    for name, (p, lib) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        print(json.dumps({"variant": name, "ptxas": ptxas_lines(log)}), flush=True)
        dll = ctypes.CDLL(str(lib))
        if name == "replaced":
            fn = dll.capital_write_diag_replaced
            fn.argtypes = argtypes[:7] + argtypes[8:]  # no route code
        else:
            fn = dll.capital_write_diag
            fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def launcher(entries, name, out, W, route=None):
    """One launch of build `name` (uncounted): the replaced kernel, or a
    build of the tree's source on `route` (default: the rule's)."""
    route = route or hopper.write_diag_route(out, W)
    args = [hopper._DTYPE_CODE[W.dtype], hopper._DTYPE_CODE[out.dtype], W.data_ptr(), out.data_ptr(),
            out.stride(0), W.shape[0], W.shape[1]]
    if name != "replaced":
        args.append(hopper.WRITE_DIAG_ROUTES[route])
    fn = entries[name]

    def run():
        rc = fn(*args, hopper._stream())
        assert rc == 0, (name, route, rc)

    return run


def parent_wrapper(entries):
    """The replaced wrapper, line for line (its launch counted on a scratch
    Kernel): the parent's host cost around the replaced kernel."""
    scratch = hopper.Kernel("replaced", "", "")

    def write(out, W):
        count, s = hopper._diag_spec(out, W)
        if not hopper._on_card(out, W):
            return hopper.write_diag_blocks_plain(out, W)
        hopper._kernel_operand(out, "out")
        if W.dtype not in hopper._DTYPE_CODE:
            raise TypeError(f"write_diag_blocks: W must be bf16, f32 or f64, got {W.dtype}")
        if count == 0 or s == 0:
            return out
        W = W.contiguous()
        rc = entries["replaced"](
            hopper._DTYPE_CODE[W.dtype], hopper._DTYPE_CODE[out.dtype], W.data_ptr(), out.data_ptr(),
            out.stride(0), count, s, hopper._stream(),
        )
        hopper._launched(rc, scratch)
        return out

    return write


def specials(dt) -> list:
    tiny = {torch.bfloat16: [2.0**-130, -(2.0**-133)], torch.float32: [1e-40, -3e-45, 2.0**-130],
            torch.float64: [1e-310, -5e-324, 1e-40, 1e-45, 1e39, -3.3961e38]}[dt]
    return [float("nan"), float("inf"), float("-inf"), -0.0, 0.0, 3.3961e38, *tiny]


def operand(count, s, dt, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    W = torch.randn((count, s, s), generator=g, device=dev, dtype=torch.float64).to(dt)
    flat = W.view(-1)
    sp = torch.tensor(specials(dt), dtype=torch.float64, device=dev).to(dt)[:flat.numel()]
    flat[torch.arange(len(sp), device=dev) * (flat.numel() // len(sp))] = sp  # spread over the blocks
    flat[-len(sp):] = sp
    return W


def checks(entries, dev) -> tuple[int, int]:
    done = failed = 0

    def report(ok, **what):
        nonlocal done, failed
        done += 1
        if not ok:
            failed += 1
            print(json.dumps({"FAIL": what}), flush=True)

    def buffer(p, dt, col):
        return torch.full((p, p + 16), float("nan"), dtype=dt, device=dev)[:, col:col + p]

    def same(a, b):
        return torch.equal(a.contiguous().view(BITS[a.dtype]), b.contiguous().view(BITS[b.dtype]))

    cases = [(3, s, dw, do, col) for s in CHECK_S for dw in DTYPES for do in DTYPES for col in (0, 1, 8)]
    cases += [(count, s, dw, do, 0) for count, s, dw, do in TIMED]
    for count, s, dw, do, col in cases:
        W = operand(count, s, dw, s + 7 * col, dev)
        p = count * s
        ref = buffer(p, do, col)
        launcher(entries, "replaced", ref, W)()
        rule = hopper.write_diag_route(ref, W)
        runs = {"wrapper": lambda o: hopper.write_diag_blocks(o, W),
                "elem": lambda o: launcher(entries, "tree", o, W, "elem")()}
        if rule == "vec":
            runs["vec"] = lambda o: launcher(entries, "tree", o, W, "vec")()
            runs.update({v: lambda o, v=v: launcher(entries, v, o, W, "vec")() for v in VARIANTS})
        for name, run in runs.items():
            got = buffer(p, do, col)
            run(got)
            torch.cuda.synchronize()
            report(same(got, ref), run=name, route=rule, count=count, s=s, w=str(dw), out=str(do), col=col)
            del got
        del ref, W
        torch.cuda.empty_cache()
    return done, failed


def timings(entries, dev) -> None:
    for count, s, dw, do in TIMED:
        p = count * s
        W = operand(count, s, dw, 11, dev)
        out = torch.full((p, p), float("nan"), dtype=do, device=dev)
        rule = hopper.write_diag_route(out, W)
        blocks = out.as_strided((count, s, s), (s * p + s, p, 1))
        parent = parent_wrapper(entries)
        fns = {"parent": lambda: parent(out, W), "tree": lambda: hopper.write_diag_blocks(out, W),
               "replaced": launcher(entries, "replaced", out, W), "tree_c": launcher(entries, "tree", out, W)}
        if rule == "vec":
            fns.update({v: launcher(entries, v, out, W) for v in VARIANTS})
        fns["copy_"] = lambda: blocks.copy_(W)
        flat = torch.empty_like(W, dtype=do)
        fns["copy_flat"] = lambda: flat.copy_(W)
        names = list(fns)
        wall = {v: [] for v in names}
        queued = {v: [] for v in names}
        device = {}
        for turn in range(TURNS):
            for v in (names if turn % 2 == 0 else names[::-1]):
                wall[v].append(chip_smoke.time_ms(fns[v], 20))
                queued[v].append(chip_smoke.queued_ms(fns[v], 20))
                if turn == 0:
                    device[v] = chip_smoke.device_ms(fns[v], 20)
        nbytes = float(count * s * s * (W.element_size() + out.element_size()))
        bound = nbytes / chip_smoke.MEM_BYTES_PER_S * 1e3
        print(json.dumps({"case": f"{count} x {s}² {dw} into {p}² {do}", "route": rule, "bound_ms": bound,
                          **{v: dict(wall_ms=statistics.median(wall[v]), queued_ms=statistics.median(queued[v]),
                                     device_ms=device[v], wall_runs=wall[v], queued_runs=queued[v])
                             for v in names}}), flush=True)
        del out, blocks, W, flat
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-timing", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("write_diag: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    root = _build.build_dir().parent / "probes" / "write_diag"
    shutil.rmtree(root, ignore_errors=True)
    entries = build(root)
    dev = torch.device("cuda")
    done, failed = checks(entries, dev)
    print(json.dumps({"checks": done, "bit_for_bit": done - failed}), flush=True)
    if failed:
        print(json.dumps({"result": "FAIL: not bit for bit the replaced kernel"}), flush=True)
        return 1
    if not args.skip_timing:
        timings(entries, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
