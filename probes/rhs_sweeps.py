"""The chain's right-hand-side sweeps — `blocktri_small.forward_solve_step`,
`solve_backward_step` and the fused step's RHS stage — on their blocked
route against the column sweeps they replaced, on the card.

    python3 probes/rhs_sweeps.py [--skip-timing]

One process, one build (the tree's, `_build.build()`): the replaced kernels
are the tree's 'sweep' route (route code 0 of the C entries,
`chip_smoke.bt_entry`), odd-ld tiles and the column sweeps, one CUDA block
a problem; the blocked route runs through the wrappers (the rules' route and
column split: the fused step's split blocks each run the factor again) and
through the C entries unsplit and with the carry through the scratch (a
stage one column narrower than a block's columns).

Checks (every one bit for bit against the sweep route, NaN patterns
included): the solve steps and the fused step at batch 3 x seg 3, b in
{16, 50, 128, 136}, k in {1, 3, 33, 64, 257}, f32 and bf16, healthy and with
faults in problem 1's chain block 1 (solve steps: a NaN / −inf right-hand
side, a zero / NaN diagonal of L, a NaN coupling; fused step: a NaN / −inf /
indefinite diagonal block, a NaN right-hand side), and the solve steps at
the 'sweep' route's b = 166 through the wrappers.  Prints one JSON line per
failed check and a count.

Then timings in turns (v0 .. vN, vN .. v0; wall by CUDA events, device time
from a trace, `queued_ms`): the solve steps at 8 x 8 x 128 x {1, 257},
264 x 8 x 128 x 33 and 16 x 7 x 16 x 34 f32 on 'sweep', 'blocked unsplit'
and the wrapper; the fused step at 8 x 8 x 128 x {1, 257} and
264 x 8 x 128 x 33 on 'sweep', 'blocked unsplit' and the wrapper, beside
the factor step on both routes (the RHS stage's time is the difference);
and blocktri.posv at the flagship (64 blocks of 128, one problem, one RHS)
under 'auto' (partitioned) with the fused step split (the rule) and
unsplit, beside 'pallas' and 'xla'.  Prints the ptxas register and spill
lines of blocktri_small.cu and the card's name and power limit.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from capital_tpu_torch.models import blocktri  # noqa: E402
from capital_tpu_torch.ops import _build, blocktri_small  # noqa: E402

CHECK_B = (16, 50, 128, 136)
CHECK_K = (1, 3, 33, 64, 257)
SOLVES = {"bt.forward_solve": blocktri_small.forward_solve_step,
          "bt.solve_backward": blocktri_small.solve_backward_step}
SOLVE_FAULTS = ("none", "nan_rhs", "-inf_rhs", "zero_diag", "nan_diag", "nan_coupling")
FUSED_FAULTS = ("none", "nan", "-inf", "indefinite", "nan_rhs")
TIMED_SOLVE = ((8, 8, 128, 1), (8, 8, 128, 257), (264, 8, 128, 33), (16, 7, 16, 34))
TIMED_FUSED = ((8, 8, 128, 1), (8, 8, 128, 257), (264, 8, 128, 33))


def narrow(kernel, b, k, splits) -> int:
    """Stage columns one fewer than a CUDA block's widest range, and no more
    than the blocked stage holds: the carry then goes through the scratch."""
    return max(1, min(-(-k // splits) - 1, blocktri_small._stage_cols(kernel, b, k, splits, "blocked")))


def operands(batch, seg, b, k, dt, seed, dev):
    """A scan step's operands (`chip_smoke.bt_operands`) and the factor
    (L, Wt) the fused step computes from them (its plain version past the
    fused step's envelope, b > 138)."""
    D, C, B, Lc, yc = chip_smoke.bt_operands(batch, seg, b, k, torch.float32, seed, dev)
    D, C, B, Lc, yc = (x.to(dt) for x in (D, C, B, Lc, yc))
    fused = blocktri_small.fused_forward_step if b <= 138 else blocktri_small.fused_forward_step_plain
    L, Wt, _, _ = fused(D, C, B, Lc, yc)
    return D, C, B, Lc, yc, L, Wt


def fused_fault(D, C, B, fault):
    D, C, B = D.clone(), C.clone(), B.clone()
    b = D.shape[-1]
    if fault == "nan":
        D[1, 1, 5 % b, 7 % b] = float("nan")
    elif fault == "-inf":
        D[1, 1, 0, 0] = -float("inf")
    elif fault == "indefinite":
        D[1, 1] = torch.eye(b, device=D.device, dtype=D.dtype)
        D[1, 1, b // 2, b // 2] = -5.0
        C[1, 1] = 0
    elif fault == "nan_rhs":
        B[1, 1, 3, 0] = float("nan")
    return D, C, B


def solve_fault(L, Wt, B, fault):
    L, Wt, B = L.clone(), Wt.clone(), B.clone()
    b, k = B.shape[-2:]
    if fault == "nan_rhs":
        B[1, 1, 5, 0] = float("nan")
    elif fault == "-inf_rhs":
        B[1, 1, 0, k - 1] = -float("inf")
    elif fault == "zero_diag":
        L[1, 1, b // 3, b // 3] = 0
    elif fault == "nan_diag":
        L[1, 1, 7, 7] = float("nan")
    elif fault == "nan_coupling":
        Wt[1, 1, 9, 4] = float("nan")
    return L, Wt, B


def checks(dev) -> bool:
    n = bad = 0

    def held(label, got, want):
        nonlocal n, bad
        n += 1
        if not chip_smoke.bt_same(got, want):
            bad += 1
            print(json.dumps({"check": label, "bitwise": False}), flush=True)

    for dt in (torch.float32, torch.bfloat16):
        for b in CHECK_B:
            for k in CHECK_K:
                D, C, B, Lc, yc, L, Wt = operands(3, 3, b, k, dt, 100 + b + k, dev)
                for fault in FUSED_FAULTS:
                    args = fused_fault(D, C, B, fault) + (Lc, yc)
                    got = blocktri_small.fused_forward_step(*args)
                    tag = f"fused {b}x{k} {dt} {fault}"
                    held(tag + " sweep", got, chip_smoke.bt_entry("bt.fused_forward", args, "sweep"))
                    held(tag + " unsplit", got, chip_smoke.bt_entry("bt.fused_forward", args, "blocked", 1))
                    if k > 1:
                        kc = narrow("fused_forward", b, k, 1)
                        held(tag + " narrow stage", got,
                             chip_smoke.bt_entry("bt.fused_forward", args, "blocked", 1, kc))
                for fault in SOLVE_FAULTS:
                    Lf, Wf, Bf = solve_fault(L, Wt, B, fault)
                    for name, fn in SOLVES.items():
                        args = (Lf, Wf, Bf, yc)
                        got = fn(*args)
                        tag = f"{name} {b}x{k} {dt} {fault}"
                        held(tag + " sweep", got, chip_smoke.bt_entry(name, args, "sweep"))
                        held(tag + " unsplit", got, chip_smoke.bt_entry(name, args, "blocked", 1))
                        if k > 1:
                            s = blocktri_small.rhs_splits(name[3:], 3, b, k)
                            held(tag + " scratch carry", got,
                                 chip_smoke.bt_entry(name, args, "blocked", s, narrow(name[3:], b, k, s)))
        # the solve steps' sweep route through the wrappers
        D, C, B, Lc, yc, L, Wt = operands(3, 3, 166, 5, dt, 7, dev)
        for name, fn in SOLVES.items():
            assert blocktri_small.chain_route(166, name[3:]) == "sweep"
            held(f"{name} 166x5 {dt} wrapper", fn(L, Wt, B, yc), chip_smoke.bt_entry(name, (L, Wt, B, yc)))
    print(json.dumps({"checks": n, "failed": bad}), flush=True)
    return bad == 0


def turns(cases: dict, order) -> None:
    """Each case on each variant in turns (v0 .. vN, vN .. v0): mean wall
    of the two readings, device time from a trace and queued time from the
    first turn."""
    res = {c: {v: [] for v in order if v in cases[c]} for c in cases}
    dev_ms = {c: {} for c in cases}
    q_ms = {c: {} for c in cases}
    for turn, v in enumerate(list(order) + list(order)[::-1]):
        for c, variants in cases.items():
            if v not in variants:
                continue
            fn, it = variants[v]
            res[c][v].append(chip_smoke.time_ms(fn, it))
            if turn < len(order):
                dev_ms[c][v] = chip_smoke.device_ms(fn, it)
                q_ms[c][v] = chip_smoke.queued_ms(fn, it)
    for c in cases:
        print(json.dumps({"case": c, **{v: sum(r) / len(r) for v, r in res[c].items()}, "runs": res[c],
                          "device_ms": dev_ms[c], "queued_ms": q_ms[c]}), flush=True)


def timings(dev) -> None:
    cases = {}
    for shape in TIMED_SOLVE:
        batch, seg, b, k = shape
        D, C, B, Lc, yc, L, Wt = operands(*shape, torch.float32, 5, dev)
        args = (L, Wt, B, yc)
        for name, fn in SOLVES.items():
            cases[f"{name} {'x'.join(map(str, shape))}"] = {
                "sweep": (lambda name=name, args=args: chip_smoke.bt_entry(name, args, "sweep"), 5),
                "unsplit": (lambda name=name, args=args: chip_smoke.bt_entry(name, args, "blocked", 1), 5),
                "tree": (lambda fn=fn, args=args: fn(*args), 5)}
    for shape in TIMED_FUSED:
        batch, seg, b, k = shape
        D, C, B, Lc, yc, _, _ = operands(*shape, torch.float32, 6, dev)
        args = (D, C, B, Lc, yc)
        cases[f"bt.fused_forward {'x'.join(map(str, shape))}"] = {
            "sweep": (lambda args=args: chip_smoke.bt_entry("bt.fused_forward", args, "sweep"), 5),
            "unsplit": (lambda args=args: chip_smoke.bt_entry("bt.fused_forward", args, "blocked", 1), 5),
            "tree": (lambda args=args: blocktri_small.fused_forward_step(*args), 5)}
        cases[f"bt.factor {'x'.join(map(str, shape))}"] = {
            "sweep": (lambda D=D, C=C, Lc=Lc: chip_smoke.bt_entry("bt.factor", (D, C, Lc), "sweep"), 5),
            "tree": (lambda D=D, C=C, Lc=Lc: blocktri_small.factor_step(D, C, Lc), 5)}
    turns(cases, ("sweep", "unsplit", "tree"))


#: clock64() stamps of CUDA block (0, 0)'s thread 0, summed over chain
#: blocks: (before, after) text edits of blocktri_small.cu; the solve steps'
#: parts at g_cyc[5·FORWARD + i], the fused step's at g_cyc[10 + i]
SOLVE_PARTS = ("tile loads + stage in", "coupling product", "triangular solve", "stage out", "blocks")
FUSED_PARTS = ("factor", "tile stores", "stage in", "coupling product", "triangular solve", "stage out",
               "L_i copy", "blocks")
_REC = "if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) "
STAMPS = (
    ("    if constexpr (FORWARD) {\n      load_tile_t4(Lf, ld, L + blk * bb, b);\n",
     "    const long long s0 = clock64();\n    if constexpr (FORWARD) {\n      load_tile_t4(Lf, ld, L + blk * bb, b);\n"),
    ("      else stage_in2(R, B + blk * bk, Yn, resident ? nullptr : (const float*)carry, lds, k, c0, w, b);\n"
     "      __syncthreads();\n      couple(A, ld, Yn, R, lds, b, w);\n      __syncthreads();\n",
     "      else stage_in2(R, B + blk * bk, Yn, resident ? nullptr : (const float*)carry, lds, k, c0, w, b);\n"
     "      __syncthreads();\n      const long long s1 = clock64();\n      couple(A, ld, Yn, R, lds, b, w);\n"
     "      __syncthreads();\n      const long long s2 = clock64();\n"),
    ("      stage_out(out + blk * bk, carry, R, lds, k, c0, w, b);\n      if (resident) {",
     "      const long long s3 = clock64();\n      stage_out(out + blk * bk, carry, R, lds, k, c0, w, b);\n"
     "      __syncthreads();\n      " + _REC + "{\n        long long* g = g_cyc + 5 * FORWARD;\n"
     "        g[0] += s1 - s0; g[1] += s2 - s1; g[2] += s3 - s2; g[3] += clock64() - s3; g[4] += 1;\n      }\n"
     "      if (resident) {"),
    ("    const int inf = factor_block_blocked(P, W, S, ld, D + blk * bb, C + blk * bb, b);\n    if (owner) {",
     "    const long long f0 = clock64();\n"
     "    const int inf = factor_block_blocked(P, W, S, ld, D + blk * bb, C + blk * bb, b);\n"
     "    const long long f1 = clock64();\n    if (owner) {"),
    ("    fused_rhs(S, W, ld, R, Yp, lds,",
     "    __syncthreads();\n    const long long f2 = clock64();\n    fused_rhs(S, W, ld, R, Yp, lds,"),
    ("      reinterpret_cast<float4*>(P)[e] = reinterpret_cast<const float4*>(S)[e];\n    __syncthreads();\n",
     "      reinterpret_cast<float4*>(P)[e] = reinterpret_cast<const float4*>(S)[e];\n    __syncthreads();\n"
     "    " + _REC + "{\n      long long* g = g_cyc + 10;\n"
     "      g[0] += f1 - f0; g[1] += f2 - f1; g[6] += clock64() - f3; g[7] += 1;\n    }\n"),
    ("    for (int e = threadIdx.x; e < rows * ld / 4; e += NT)  // L_i carried on\n",
     "    const long long f3 = clock64();\n"
     "    for (int e = threadIdx.x; e < rows * ld / 4; e += NT)  // L_i carried on\n"),
    # inside fused_rhs: its four parts, summed over chunks
    ("    if (first) stage_in2(R, rhs, Yp, first, lds, k, c0, w, b);\n",
     "    const long long r0 = clock64();\n    if (first) stage_in2(R, rhs, Yp, first, lds, k, c0, w, b);\n"),
    ("    __syncthreads();\n    couple(W, ld, Yp, R, lds, b, w);\n    __syncthreads();\n"
     "    fwd_blocked<true, true>(S, ld, b, R, lds, w);\n    stage_out(out, carry, R, lds, k, c0, w, b);\n"
     "    __syncthreads();  // the next chunk overwrites the stage; the carry is in\n",
     "    __syncthreads();\n    const long long r1 = clock64();\n    couple(W, ld, Yp, R, lds, b, w);\n"
     "    __syncthreads();\n    const long long r2 = clock64();\n    fwd_blocked<true, true>(S, ld, b, R, lds, w);\n"
     "    const long long r3 = clock64();\n    stage_out(out, carry, R, lds, k, c0, w, b);\n"
     "    __syncthreads();  // the next chunk overwrites the stage; the carry is in\n"
     "    " + _REC + "{\n      long long* g = g_cyc + 10;\n"
     "      g[2] += r1 - r0; g[3] += r2 - r1; g[4] += r3 - r2; g[5] += clock64() - r3;\n    }\n"),
)
PROBE_FNS = ('\nextern "C" int probe_cycles(long long* out) '
             '{ return (int)cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc)); }\n'
             'extern "C" int probe_reset(const long long* in) '
             '{ return (int)cudaMemcpyToSymbol(g_cyc, in, sizeof(g_cyc)); }\n')


def stamped_source() -> str:
    text = (_build.CSRC / "blocktri_small.cu").read_text()
    for old, new in STAMPS:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    text = text.replace('#include "batched_small.cuh"\n',
                        '#include "batched_small.cuh"\n\n__device__ long long g_cyc[20];\n', 1)
    return text + PROBE_FNS


def phases(dev) -> None:
    """Block (0, 0)'s cycles by part of a chain block, from a stamped build
    of blocktri_small.cu, at 8 x 8 x 128 x 1 and x 257 f32."""
    root = _build.build_dir().parent / "probes" / "rhs_sweeps"
    shutil.rmtree(root, ignore_errors=True)
    csrc = root / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    (csrc / "blocktri_small.cu").write_text(stamped_source())
    lib_path = root / "blocktri_small.so"
    out = subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(lib_path), str(csrc / "blocktri_small.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError("stamped build failed\n" + out.stderr[-3000:])
    st = _build._Kernels()
    tree = _build._STATE
    st.libs = dict(tree.libs)
    lib = st.libs["blocktri_small.cu"] = ctypes.CDLL(str(lib_path))
    for fn, (src, argtypes) in _build.SIGNATURES.items():
        if src == "blocktri_small.cu":
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, ctypes.c_int
    read, reset = lib.probe_cycles, lib.probe_reset
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    reset.argtypes, reset.restype = [ctypes.c_void_p], ctypes.c_int
    _build._STATE = st
    try:
        for shape in ((8, 8, 128, 1), (8, 8, 128, 257)):
            D, C, B, Lc, yc, L, Wt = operands(*shape, torch.float32, 9, dev)
            runs = {"forward_solve": lambda: blocktri_small.forward_solve_step(L, Wt, B, yc),
                    "solve_backward": lambda: blocktri_small.solve_backward_step(L, Wt, B, yc),
                    "fused_forward": lambda: blocktri_small.fused_forward_step(D, C, B, Lc, yc)}
            for name, run in runs.items():
                run()
                torch.cuda.synchronize()
                assert reset((ctypes.c_longlong * 20)()) == 0
                run()
                torch.cuda.synchronize()
                buf = (ctypes.c_longlong * 20)()
                assert read(buf) == 0
                if name == "fused_forward":
                    g, parts = buf[10:18], FUSED_PARTS
                else:
                    g, parts = buf[5 * (name == "forward_solve"):][:5], SOLVE_PARTS
                n = max(g[-1], 1)
                print(json.dumps({"phases": name, "shape": list(shape), "chunks": g[-1],
                                  "cycles_per_chunk": {parts[i]: g[i] / n for i in range(len(parts) - 1)}}),
                      flush=True)
    finally:
        _build._STATE = tree


class FusedUnsplit:
    """The fused step unsplit inside the wrappers (the rule before it took
    the column split), for this probe's flagship comparison only."""

    def __enter__(self):
        self.saved = blocktri_small._SPLIT_KERNELS
        blocktri_small._SPLIT_KERNELS = tuple(k for k in self.saved if k != "fused_forward")
        blocktri_small._rhs_launch.cache_clear()

    def __exit__(self, *exc):
        blocktri_small._SPLIT_KERNELS = self.saved
        blocktri_small._rhs_launch.cache_clear()


def flagship(dev) -> None:
    nb, b, batch, k = chip_smoke.BT_FLAGSHIP
    D, C, B = chip_smoke.chain_operands(batch, nb, b, k, 12, dev)

    def unsplit_auto():
        with FusedUnsplit():
            return blocktri.posv(D, C, B, impl="auto")

    same = chip_smoke.bt_same(unsplit_auto(), blocktri.posv(D, C, B, impl="auto"))
    runs = {"pallas": lambda: blocktri.posv(D, C, B, impl="pallas"),
            "auto": lambda: blocktri.posv(D, C, B, impl="auto"), "auto_unsplit": unsplit_auto,
            "xla": lambda: blocktri.posv(D, C, B, impl="xla")}
    t = chip_smoke.turns_s(runs, 7, 3)
    for impl, run in runs.items():
        prof = chip_smoke.complete_profile(run, "BT::")
        t[impl].update(idle_share=prof["idle_share"], device_busy_ms=prof["device_busy_ms"],
                       records_lost=prof["records_lost"])
    print(json.dumps({"flagship": f"{nb} x {b}, batch {batch}, k {k} f32", "split_same_bits": same, **t}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-timing", action="store_true")
    ap.add_argument("--phases-only", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("rhs_sweeps: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    src = "blocktri_small.cu"
    log = _build._STATE.logs.get(src) or (_build.build_dir() / (Path(src).stem + ".log")).read_text()
    print(json.dumps({"source": src, "ptxas": [ln.strip() for ln in log.splitlines()
                                                if "registers" in ln or "spill" in ln or "Function properties" in ln
                                                or "Compiling entry" in ln]}), flush=True)
    dev = torch.device("cuda")
    stamped_source()  # the stamps still apply to the tree's source
    if opts.phases_only:
        phases(dev)
        return 0
    if not checks(dev):
        print(json.dumps({"result": "FAIL: not bit for bit the sweep route"}), flush=True)
        return 1
    if not opts.skip_timing:
        timings(dev)
        flagship(dev)
    phases(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
