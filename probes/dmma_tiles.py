"""The DMMA loop's tile shape against its alternatives, on the card.

    python3 probes/dmma_tiles.py

Builds copies of capital_tpu_torch/ops/csrc under build/probes/ with the
DMMA constants of csrc/mm_tiles.cuh replaced (`VARIANTS`), compiles
tri_matmul.cu and sched_matmul.cu of every variant in parallel, holds each
to the plain version on ragged windows (every orientation, NaN in a dead
triangle), then times the f64 calls of chip_smoke.py's phase 2, the
phase-17 flagship slabs (f64, and f32 on the fma loop) and the f64
cholinv n=16384 on one device and on the 2x2x1 mesh on every variant,
interleaved (v0 .. vN, vN .. v0).  One JSON line per variant; its ptxas
register and spill line first.
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from capital_tpu_torch import Grid  # noqa: E402
from capital_tpu_torch.models import cholesky  # noqa: E402
from capital_tpu_torch.ops import _build, hopper  # noqa: E402
from capital_tpu_torch.parallel import summa  # noqa: E402

#: each variant: the DMMA constants of mm_tiles.cuh it sets (the others as
#: in the tree) and text replacements in sched_matmul.cu
RANKED = ("  const int pos = blockIdx.y;\n  if (p.fi[pos] != 1) return;\n  extern",
          "  int pos, pairs;\n  if (!pick_run(p, pos, pairs)) return;\n  extern")
VARIANTS = {
    "tree": ({}, ()),
    "sched_dmma runs longest first (pick_run)": ({}, (RANKED,
        ("nk = run_pairs(p, pos) * per;\n  mmt::Win<double>", "nk = pairs * per;\n  mmt::Win<double>"))),
    "128x64, 4 warps of 64x32, 2/SM": (dict(D_BN=64, D_WM=64, D_WN=32, D_MINB=2), ()),
    "64x128, 4 warps of 32x64, 2/SM": (dict(D_BM=64, D_WM=32, D_WN=64, D_MINB=2), ()),
    "16 warps of 32x32": (dict(D_WM=32, D_WN=32), ()),
    "k32 s2": (dict(D_STAGES=2), ()),
    "k16 s3": (dict(D_BK=16), ()),
}
SOURCES = ("tri_matmul.cu", "sched_matmul.cu")


def variant_csrc(base: Path, root: Path, consts: dict, subs) -> Path:
    """A copy of `base` (a csrc directory) under `root` with these DMMA
    constants and sched_matmul.cu replacements."""
    csrc = root / "capital_tpu_torch/ops/csrc"
    shutil.copytree(base, csrc)
    f = csrc / "mm_tiles.cuh"
    s = f.read_text()
    for name, v in consts.items():
        s, n = re.subn(rf"\b{name} = \d+", f"{name} = {v}", s)
        assert n == 1, name
    f.write_text(s)
    f = csrc / "sched_matmul.cu"
    s = f.read_text()
    for old, new in subs:
        assert old in s, old
        s = s.replace(old, new)
    f.write_text(s)
    return csrc.resolve()


def build_all(root: Path) -> dict:
    """Compile every variant's two sources at once; returns each variant's
    loaded kernels (a `_build._Kernels`), the tree's own build of the other
    sources shared by all."""
    base, sources, signatures = _build.CSRC, _build.SOURCES, dict(_build.SIGNATURES)
    _build.build()
    tree = _build._STATE
    _build.SOURCES = SOURCES
    _build.SIGNATURES = {k: v for k, v in signatures.items() if v[0] in SOURCES}
    dirs, procs = {}, []
    for name, cfg in VARIANTS.items():
        _build.CSRC = dirs[name] = variant_csrc(base, root / re.sub(r"\W+", "_", name), *cfg)
        _build.build_dir().mkdir(parents=True, exist_ok=True)
        for src in SOURCES:
            cmd = [_build.nvcc(), *_build.FLAGS, "-o", str(_build._lib_path(src)), str(_build.CSRC / src)]
            procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Function properties for _Z7mm_dmmaILb1ELb0" in line:
                print(json.dumps({"variant": name, "ptxas": " | ".join(x.strip() for x in lines[i + 1:i + 3])}))
    states = {}
    for name, csrc in dirs.items():
        _build.CSRC, _build._STATE = csrc, _build._Kernels()
        _build.build()
        for src in sources:
            _build._STATE.libs.setdefault(src, tree.libs[src])
        states[name] = _build._STATE
    _build.CSRC, _build.SOURCES, _build.SIGNATURES = base, sources, signatures
    return states


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
        print("dmma_tiles: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    root = Path(_build.build_dir()).parent / "probes" / "dmma_tiles"
    shutil.rmtree(root, ignore_errors=True)
    states = build_all(root)
    dev, dt = torch.device("cuda"), torch.float64
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *sh: torch.randn(*sh, generator=g, device=dev, dtype=dt)  # noqa: E731

    A, B = rnd(2048, 2048), rnd(2048, 2048)
    An = A.clone()
    An[64:584, 128:648].masked_fill_(torch.tril(torch.ones(520, 520, dtype=torch.bool, device=dev), -1),
                                     float("nan"))
    for name, st in states.items():
        _build._STATE = st
        worst = 0.0
        for at in (False, True):
            for bt in (False, True):
                for X, kw in ((A, dict(a_view=(8, 16, 777, 1000) if at else (8, 16, 1000, 777),
                                       b_view=(16, 8, 520, 777) if bt else (16, 8, 777, 520))),
                              (An, dict(a_uplo="U", a_view=(64, 128, 520, 520),
                                        b_view=(8, 256, 777, 520) if bt else (8, 256, 520, 777)))):
                    got = hopper.tri_matmul(X, B, a_trans=at, b_trans=bt, **kw)
                    want = hopper.tri_matmul_plain(X, B, a_trans=at, b_trans=bt, **kw)
                    worst = max(worst, float((got - want).abs().max() / want.abs().max()))
        print(json.dumps({"variant": name, "max_rel_err_vs_plain": worst}))
        if not worst <= 1e-12:
            return 1
    del A, B, An

    W, D = 8192, 4096
    RIp, buf = rnd(2 * W, 2 * W), rnd(2 * W, 2 * W)
    out = buf.clone()
    (TO, KO, FI, LA), _, blocks = summa._sched_host(2, 8192, 8192, 8192, "L", None)
    SA, SB = rnd(4096, 8192), rnd(8192, 4096)
    SA32, SB32 = SA.float(), SB.float()
    row = [torch.from_numpy(x[1].copy()).to(dev) for x in (TO, KO, FI, LA)]
    G = rnd(16384, 16384) / 128.0
    spd = G @ G.T + 3.0 * torch.eye(16384, dtype=dt, device=dev)
    del G
    one, mesh = Grid.square(device=dev), Grid.rect(2, 2, 1, devices=[dev] * 4)
    cases = {
        "trmm": lambda: hopper.tri_matmul(RIp, buf, a_uplo="U", a_trans=True, a_view=(0, 0, W, W),
                                          b_view=(0, W, W, W), out=out, out_off=(0, W)),
        "syrk": lambda: hopper.tri_matmul(RIp, RIp, a_trans=True, out_uplo="U", alpha=-1.0, beta=1.0,
                                          a_view=(0, W, W, W), b_view=(0, W, W, W), c=out,
                                          c_view=(W, W, W, W), out=out, out_off=(W, W)),
        "dense": lambda: hopper.tri_matmul(buf, RIp, b_trans=True, a_view=(0, 0, D, D), b_view=(D, 0, D, D)),
        "sched": lambda: hopper.sched_matmul(SA, SB, *row, tri_side="a", blocks=blocks),
        "sched f32 (fma)": lambda: hopper.sched_matmul(SA32, SB32, *row, tri_side="a", blocks=blocks),
        "cholinv f64 n=16384": lambda: cholesky.factor(
            one, spd, cholesky.CholinvConfig(mode="pallas", base_case_dim=512)),
        "mesh cholinv f64 n=16384": lambda: cholesky.factor(
            mesh, spd, cholesky.CholinvConfig(mode="explicit", base_case_dim=512)),
    }
    res = {name: {case: [] for case in cases} for name in states}
    for name in list(states) + list(states)[::-1]:
        _build._STATE = states[name]
        for case, fn in cases.items():
            res[name][case].append(time_ms(fn, 3))
    for name, r in res.items():
        print(json.dumps({"variant": name, "cfg": VARIANTS[name][0], **{c: sum(v) / len(v) for c, v in r.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
