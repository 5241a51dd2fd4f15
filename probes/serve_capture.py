"""Which serve bucket programs capture as a CUDA graph, on the card.

    python3 probes/serve_capture.py [--out serve_capture.json]

For every kind of bucket program the engine builds, it asks for the
capture (`serve/program.Program(capture=True)`) whatever
`program.capturable` rules, and prints one JSON line: whether the capture
succeeded (else the error), the rule's answer, the kernel launches at
capture, and whether a replay on a seeded batch of well-posed problems is
bit for bit an eager call of the same `api.batched` program on the same
batch (NaN patterns included).  Two sets:

* `CASES`, named, at the engine phase's widths (n up to 128, chains of 64
  blocks of 128): also the host wall per call (a synchronized call,
  median of `CALLS`) of the replay and of the eager program, in turns;
* `matrix()`, untimed: every op with a bucket program (posv, lstsq, inv,
  posv_blocktri, posv_arrowhead, chol_update, chol_downdate) x dtype (f32, f64, bf16) x small_n_impl x chain
  algorithm (chain ops) x tier (the tiered ops) x capacity (1 and 8) at
  small widths — the library routes' single-matrix and batched cuSOLVER /
  cuBLAS paths both.

A probe may try a capture that fails; the engine never does
(`capturable` decides).  Prints a summary line and the card's name and
power limit.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from capital_tpu_torch.ops import _build  # noqa: E402
from capital_tpu_torch.serve import api, batching, program  # noqa: E402
from capital_tpu_torch.serve.engine import ServeConfig  # noqa: E402

CALLS = 30
LADDERS = dict(buckets=(32, 64, 128), rows_buckets=(128, 256, 512), nrhs_buckets=(1, 8, 64), max_batch=8)

#: (label, op, a_shape, b_shape, dtype, tier, small_n_impl, blocktri_impl)
CASES = (
    ("posv f32 auto", "posv", (128, 128), (128, 8), "float32", "balanced", "auto", "auto"),
    ("posv f32 pallas", "posv", (64, 64), (64, 8), "float32", "balanced", "pallas", "auto"),
    ("posv f32 pallas_split", "posv", (128, 128), (128, 8), "float32", "balanced", "pallas_split", "auto"),
    ("posv bf16 auto", "posv", (128, 128), (128, 8), "bfloat16", "balanced", "auto", "auto"),
    ("lstsq f32 auto", "lstsq", (512, 128), (512, 8), "float32", "balanced", "auto", "auto"),
    ("inv f32 auto", "inv", (128, 128), None, "float32", "balanced", "auto", "auto"),
    ("posv f32 fast", "posv", (128, 128), (128, 8), "float32", "fast", "auto", "auto"),
    ("posv f32 guaranteed", "posv", (128, 128), (128, 8), "float32", "guaranteed", "auto", "auto"),
    ("posv f64 guaranteed", "posv", (128, 128), (128, 8), "float64", "guaranteed", "auto", "auto"),
    ("lstsq f64 guaranteed", "lstsq", (512, 128), (512, 8), "float64", "guaranteed", "auto", "auto"),
    ("posv f64 fast", "posv", (128, 128), (128, 8), "float64", "fast", "auto", "auto"),
    ("blocktri f32 scan", "posv_blocktri", (2, 8, 32, 32), (8, 32, 8), "float32", "balanced", "auto", "auto"),
    ("blocktri f32 partitioned", "posv_blocktri", (2, 64, 128, 128), (64, 128, 8), "float32",
     "balanced", "auto", "auto"),
    ("blocktri f32 guaranteed", "posv_blocktri", (2, 8, 32, 32), (8, 32, 8), "float32", "guaranteed",
     "auto", "scan"),
    ("arrowhead f32 scan", "posv_arrowhead", (2, 8, 32, 32), (8 * 32 + 8, 8 + 8), "float32", "balanced",
     "auto", "auto"),
    ("arrowhead f32 partitioned", "posv_arrowhead", (2, 32, 64, 64), (32 * 64 + 32, 32 + 8), "float32",
     "balanced", "auto", "auto"),
    ("chol_update f32 auto", "chol_update", (128, 128), (128, 8), "float32", "balanced", "auto", "auto"),
    ("posv f32 vmap", "posv", (128, 128), (128, 8), "float32", "balanced", "vmap", "auto"),
    ("posv f64 auto", "posv", (128, 128), (128, 8), "float64", "balanced", "auto", "auto"),
    ("lstsq f64 auto", "lstsq", (512, 128), (512, 8), "float64", "balanced", "auto", "auto"),
    ("inv f64 auto", "inv", (128, 128), None, "float64", "balanced", "auto", "auto"),
    ("blocktri f32 xla", "posv_blocktri", (2, 8, 64, 64), (8, 64, 8), "float32", "balanced", "vmap", "auto"),
    ("blocktri f64", "posv_blocktri", (2, 8, 64, 64), (8, 64, 8), "float64", "balanced", "auto", "auto"),
)


def operands(op, a_shape, b_shape, dtype, cap, seed, dev):
    """A batch of `cap` well-posed problems at the bucket's padded shapes,
    made from a seed in f64 and cast."""
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64

    def spd(*shape):
        n = shape[-1]
        X = torch.randn(*shape, generator=g, dtype=f64)
        return X @ X.mT / n + 3.0 * torch.eye(n, dtype=f64)

    if op in ("posv", "inv"):
        A = spd(cap, a_shape[0], a_shape[0])
        B = None if b_shape is None else torch.randn(cap, *b_shape, generator=g, dtype=f64)
    elif op == "lstsq":
        A = torch.randn(cap, *a_shape, generator=g, dtype=f64)
        B = torch.randn(cap, *b_shape, generator=g, dtype=f64)
    elif op in ("chol_update", "chol_downdate"):
        n = a_shape[0]
        A = torch.linalg.cholesky(spd(cap, n, n)).mT.contiguous()
        B = 0.1 * torch.randn(cap, *b_shape, generator=g, dtype=f64)
    else:
        _, nb, b, _ = a_shape
        D = spd(cap, nb, b, b) + 2.0 * torch.eye(b, dtype=f64)
        C = 0.2 * torch.randn(cap, nb, b, b, generator=g, dtype=f64) / b ** 0.5
        C[:, 0] = 0
        A = torch.stack([D, C], dim=1)
        if op == "posv_blocktri":
            B = torch.randn(cap, *b_shape, generator=g, dtype=f64)
        else:
            s = b_shape[0] - nb * b
            k = b_shape[1] - s
            B = torch.zeros(cap, *b_shape, dtype=f64)
            B[:, : nb * b, :s] = 0.05 * torch.randn(cap, nb * b, s, generator=g, dtype=f64) / b ** 0.5
            B[:, nb * b:, :s] = spd(cap, s, s) + 4.0 * torch.eye(s, dtype=f64)
            B[:, :, s:] = torch.randn(cap, nb * b + s, k, generator=g, dtype=f64)
    dt = batching._dtype(dtype)
    return tuple(x.to(dt).to(dev) for x in (A, B) if x is not None)


def matrix():
    """(label, op, a_shape, b_shape, dtype, tier, small_n_impl,
    blocktri_impl, capacity) over every served combination at small
    widths."""
    shapes = {"posv": ((32, 32), (32, 8)), "lstsq": ((128, 32), (128, 8)), "inv": ((32, 32), None),
              "posv_blocktri": ((2, 8, 32, 32), (8, 32, 8)),
              "posv_arrowhead": ((2, 8, 32, 32), (8 * 32 + 8, 8 + 8)),
              "chol_update": ((32, 32), (32, 8)), "chol_downdate": ((32, 32), (32, 8))}
    out = []
    for op, (a, b) in shapes.items():
        tiers = ("balanced", "fast", "guaranteed") if op in api.TIER_OPS else ("balanced",)
        algos = ("auto", "scan", "partitioned") if op in batching.STRUCTURED_OPS else ("auto",)
        for dtype in ("float32", "float64", "bfloat16"):
            for impl in ("auto", "pallas", "pallas_split", "vmap"):
                for algo in algos:
                    for tier in tiers:
                        for cap in (1, 8):
                            label = f"{op} {dtype} {impl} {algo} {tier} c{cap}"
                            out.append((label, op, a, b, dtype, tier, impl, algo, cap))
    return out


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the lines as a JSON list to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_capture: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"build_s": round(_build.build(), 2)}), flush=True)
    dev = torch.device("cuda")
    lines = []
    cases = [c + (LADDERS["max_batch"], True) for c in CASES] + [c + (False,) for c in matrix()]
    for label, op, a_shape, b_shape, dtype, tier, impl, bt_impl, cap, timed in cases:
        cfg = ServeConfig(small_n_impl=impl, blocktri_impl=bt_impl, **dict(LADDERS, max_batch=cap))
        bucket = batching.Bucket(op, dtype, a_shape, b_shape, cap, tier)
        fn = api.batched(op, cfg.precision, impl, blocktri_impl=bt_impl, tier=tier)
        line = {"case": label, "bucket": batching.bucket_label(bucket),
                "capturable": program.capturable(bucket, cfg),
                "small_route": program.small_route(bucket, cfg, interpret=False)}
        try:
            prog = program.Program(fn, bucket, dev, capture=True)
        except Exception as e:  # noqa: BLE001 — the probe records which programs refuse capture
            line.update(captured=False, error=f"{type(e).__name__}: {e}"[:400],
                        where=traceback.format_exc().splitlines()[-3:])
            torch.cuda.synchronize()
            print(json.dumps(line), flush=True)
            lines.append(line)
            continue
        ins = operands(op, a_shape, b_shape, dtype, cap, len(lines), dev)
        got = prog(*ins)
        want = tuple(fn(*(x.clone() for x in ins)))
        torch.cuda.synchronize()
        same = len(got) == len(want) and all(chip_smoke.same_bits(g, w) for g, w in zip(got, want))
        line.update(captured=True, capture_counts=prog.capture_counts, capture_routes=prog.capture_routes,
                    replay_equals_eager=same, outputs=len(got))
        if timed:
            turns = {"replay": [], "eager": []}
            for i in range(CALLS):
                order = ("replay", "eager") if i % 2 == 0 else ("eager", "replay")
                for name in order:
                    f = (lambda: prog(*ins)) if name == "replay" else (lambda: fn(*ins))
                    turns[name].append(wall_ms(f))
            line.update(replay_ms=statistics.median(turns["replay"]),
                        eager_ms=statistics.median(turns["eager"]))
        if timed or not (line["captured"] and same):
            print(json.dumps(line), flush=True)
        lines.append(line)
        del prog
        torch.cuda.empty_cache()
    summary = {"cases": len(lines), "captured": sum(bool(x["captured"]) for x in lines),
               "replay_equals_eager": sum(bool(x.get("replay_equals_eager")) for x in lines),
               "rule_captures": sum(bool(x["capturable"]) for x in lines)}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "cases": lines}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
