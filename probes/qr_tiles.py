"""The f32 / f64 CholeskyQR2 tall passes' tile order and split count, on
the card.

    python3 probes/qr_tiles.py [--out readings.json]

Builds copies of capital_tpu_torch/ops/csrc/qr_fused.cu under
build/probes/qr_tiles/ with the scale kernels' grid and tile order replaced
(`VARIANTS`: the tree's one block a tile, the column tile rotated by the
row panel as in scale_wgmma; a persistent grid of one block a slot of the
H100 (132 SMs; two blocks an SM for f32), its kernel patched to walk the
tiles, for f32 and for f64; one block a tile with each row panel's longest
k-range first; the 64-bit tile map, whose 64-bit division made scale_fma
spill; each kernel in a block loop over b += gridDim.x, launched one block
a tile), compiles them in parallel, and holds each variant's Q bitwise to
the tree's.  Then times `capital_scale_blocked` of every
variant at 65536 x 512 and 2,097,152 x 1024 (f32, f64), interleaved
(v0 .. vN, vN .. v0, twice), beside one `A @ triu(Rinv)`; and
`capital_gram_blocked` of the tree at 65536 x 512 under several row-split
counts (the C entry takes any count), beside `mm(A.T, A)`.  One JSON line
per set of readings, with the card's SM clock, power draw and temperature
after it; the card's name and power limit first.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from capital_tpu_torch.ops import _build, hopper, qr_fused  # noqa: E402

ROTATED = "  j0 = (int)((b + panel) % ntn) * TILE;\n"


def persistent(kernel: str, launch: tuple | None, barrier: bool):
    """A variant whose `kernel` walks tiles b = blockIdx.x, + gridDim.x, ...
    (`launch`, if given, replaces the tree's one-block-a-tile grid by one
    block a slot); `barrier` ends each tile with a __syncthreads (the DMMA
    ring's next tile copies into stages the last one read; the FMA loop
    already ends on one)."""
    def patch(s: str) -> str:
        head = f" {kernel}(ScaleArgs p) {{\n"
        i = s.index(head) + len(head)
        i = s.index("\n", i) + 1  # the shared-memory declaration stays outside the loop
        j = s.index("\n}\n", i)
        body = s[i:j]
        assert "scale_tile32(blockIdx.x," in body, kernel
        loop = ("  for (long long b = blockIdx.x; b < p.m / TILE * (p.n / TILE); b += gridDim.x) {\n"
                + body.replace("scale_tile32(blockIdx.x,", "scale_tile32((unsigned)b,")
                + ("\n  __syncthreads();" if barrier else "") + "\n  }")
        s = s[:i] + loop + s[j:]
        if launch is None:
            return s
        assert launch[0] in s, launch[0]
        return s.replace(*launch)
    return patch


def replace(old: str, new: str):
    def patch(s: str) -> str:
        assert old in s, old
        return s.replace(old, new)
    return patch


#: each variant: a function of qr_fused.cu's text
VARIANTS = {
    "tree (one block a tile, column rotated by panel)": lambda s: s,
    "f32 persistent, one block a slot": persistent(
        "scale_fma", ("scale_fma<<<(unsigned)tiles,", "scale_fma<<<(unsigned)(tiles < 264 ? tiles : 264),"),
        barrier=False),
    "f64 persistent, one block a slot": persistent(
        "scale_dmma", ("dim3((unsigned)tiles), p, s)", "dim3((unsigned)(tiles < 132 ? tiles : 132)), p, s)"),
        barrier=True),
    "one block a tile, each panel longest k first": replace(
        ROTATED, "  j0 = (ntn - 1 - (int)(b % ntn)) * TILE;\n"),
    "one block a tile, the 64-bit tile map": replace(
        "  int i0, j0;\n  scale_tile32(blockIdx.x, p.n / TILE, i0, j0);\n",
        "  long long i0;\n  int j0;\n  scale_tile(blockIdx.x, p.n / TILE, i0, j0);\n"),
    "one block a tile, each kernel in a block loop": lambda s: persistent(
        "scale_fma", None, barrier=False)(persistent("scale_dmma", None, barrier=True)(s)),
}
#: rounds of (v0 .. vN, vN .. v0)
TURNS = 2
#: row-split counts tried on the gram at 65536 x 512, g = 4 (10 live tiles)
SPLITS = {torch.float32: (11, 13, 16, 22, 26, 32), torch.float64: (11, 13, 16, 22, 26)}


def build_variants(root: Path) -> dict:
    """Compile every variant's qr_fused.cu at once; returns each one's
    library."""
    if root.exists():
        shutil.rmtree(root)
    procs = {}
    for i, (name, patch) in enumerate(VARIANTS.items()):
        d = root / f"v{i}"
        shutil.copytree(_build.CSRC, d)
        src = d / "qr_fused.cu"
        src.write_text(patch(src.read_text()))
        cmd = [_build.nvcc(), *_build.FLAGS, "-o", str(d / "qr_fused.so"), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        regs = [x.strip() for k, ln in enumerate(lines)
                if "Function properties for" in ln and ("scale_fma" in ln or "scale_dmma" in ln)
                for x in lines[k:k + 3]]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        lib = ctypes.CDLL(str(d / "qr_fused.so"))
        for fn in ("capital_scale_blocked", "capital_gram_blocked"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn][1]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def scale(lib, A, R, Q) -> None:
    m, n = A.shape
    rc = lib.capital_scale_blocked(hopper._DTYPE_CODE[A.dtype], A.data_ptr(), A.stride(0),
                                   R.data_ptr(), R.stride(0), Q.data_ptr(), Q.stride(0), m, n,
                                   None, hopper._stream())
    if rc:
        raise RuntimeError(f"capital_scale_blocked returned {rc}")


def gram(lib, A, g, splits, G, W) -> None:
    m, n = A.shape
    rc = lib.capital_gram_blocked(hopper._DTYPE_CODE[A.dtype], A.data_ptr(), A.stride(0), m, n, g,
                                  G.data_ptr(), W.data_ptr(), splits, None, hopper._stream())
    if rc:
        raise RuntimeError(f"capital_gram_blocked returned {rc}")


def clocks() -> str:
    """The card's SM clock, power draw and temperature, read just after a
    set of timings (a card at its power limit clocks down)."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def operands(m, n, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn((m, n), generator=gen, device="cuda", dtype=dtype)
    R = torch.triu(torch.randn((n, n), generator=gen, device="cuda", dtype=dtype) * (0.1 / n**0.5)
                   + torch.eye(n, device="cuda", dtype=dtype))
    return A, R


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the readings as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qr_tiles: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"env": smi, "torch": torch.__version__}), flush=True)
    libs = build_variants(_build.build_dir().parent / "probes" / "qr_tiles")
    names = list(libs)
    out = {"env": smi, "scale": [], "gram": []}

    for (m, n), dtype in (((65536, 512), torch.float32), ((65536, 512), torch.float64),
                          ((2_097_152, 1024), torch.float32), ((2_097_152, 1024), torch.float64)):
        A, R = operands(m, n, dtype, 1)
        Q = torch.empty_like(A)
        ref = torch.empty_like(A)
        scale(libs[names[0]], A, R, ref)
        for name in names[1:]:
            scale(libs[name], A, R, Q)
            torch.cuda.synchronize()
            assert torch.equal(Q, ref), f"{name}: Q differs from the tree's"
        iters = 5 if m * n > 1 << 28 else 20
        ms = {name: [] for name in names + ["A @ triu(Rinv)"]}
        for order in (names, names[::-1]) * TURNS:
            for name in order:
                ms[name].append(time_ms(lambda: scale(libs[name], A, R, Q), iters))
            ms["A @ triu(Rinv)"].append(time_ms(lambda: torch.matmul(A, R, out=Q), iters))
        rec = {"scale": f"{m}x{n} {dtype}", "ms": ms, "card": clocks()}
        out["scale"].append(rec)
        print(json.dumps(rec), flush=True)
        del A, R, Q, ref
        torch.cuda.empty_cache()

    m, n, g = 65536, 512, 4
    for dtype in (torch.float32, torch.float64):
        A, _ = operands(m, n, dtype, 2)
        G = torch.empty((n, n), dtype=dtype, device="cuda")
        W = torch.empty((max(SPLITS[dtype]), n, n), dtype=dtype, device="cuda")
        want = torch.mm(A.t(), A)
        live = torch.triu(torch.ones(g, g, dtype=torch.bool, device="cuda")).repeat_interleave(
            n // g, 0).repeat_interleave(n // g, 1)
        rec = {"gram": f"{m}x{n} {dtype} g={g}", "tree_splits": qr_fused.gram_splits(m, n, g, dtype),
               "ms": {}}
        for turn in range(2 * TURNS):
            for s in SPLITS[dtype] if turn % 2 == 0 else SPLITS[dtype][::-1]:
                gram(libs[names[0]], A, g, s, G, W)
                torch.cuda.synchronize()
                err = float((G - want)[live].abs().max() / want.abs().max())
                assert err < (1e-12 if dtype == torch.float64 else 1e-5), (s, err)
                rec["ms"].setdefault(str(s), []).append(
                    time_ms(lambda: gram(libs[names[0]], A, g, s, G, W), 20))
            rec["ms"].setdefault("mm(A.T, A)", []).append(time_ms(lambda: torch.mm(A.t(), A), 20))
        rec["card"] = clocks()
        out["gram"].append(rec)
        print(json.dumps(rec), flush=True)
        del A, G, W, want

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
