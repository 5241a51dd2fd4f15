"""The session flagship's sliding cycle on the card, for the tree it runs from.

    python3 probes/session_cycle.py [--turns 21] [--label NAME]

Opens a 64 × 128 f32 window through `serve.SessionManager` on a
`SolveEngine` at `chip_smoke.py`'s phase-7c configuration (`SESSION_CFG`,
`SESSION_FLAGSHIP`, its seeded chain), warms every program up, then times
in turns, each call synchronized, host wall: the append of 8 blocks, the
contract of 8, the cycle (append 8 + contract 8) and a reopen of the whole
64-block window (a full refactor).  Prints one JSON line of medians and
every run, then the card's name and power limit.

Run it from two checkouts in one call (parent, change, change, parent) to
compare them: each run imports the package of the tree it is started in.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=21)
    ap.add_argument("--label", default=str(ROOT))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("session_cycle: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from capital_tpu_torch.serve import ServeConfig, SessionManager, SolveEngine

    dev = torch.device("cuda")
    nblocks, _, slide, _ = cs.SESSION_FLAGSHIP
    D, C = (x.contiguous() for x in (cs.session_data(dev)[k] for k in ("D", "C")))
    mgr = SessionManager(SolveEngine(cfg=ServeConfig(**cs.SESSION_CFG)))
    window, fresh = (D[:nblocks], C[:nblocks]), (D[nblocks:nblocks + slide], C[nblocks:nblocks + slide])

    def call(name):
        if name == "refactor":
            return mgr.open("t", *window).ok
        if name == "append":
            return mgr.append("t", *fresh).ok
        if name == "contract":
            return mgr.contract("t", slide).ok
        return mgr.append("t", *fresh).ok and mgr.contract("t", slide).ok

    names = ("append", "contract", "cycle", "refactor")
    assert call("refactor")
    for _ in range(3):  # builds and captures every program of the cycle
        assert call("append") and call("contract") and call("refactor")
    walls = {n: [] for n in names}
    for i in range(args.turns):
        order = names[i % 4:] + names[:i % 4]
        for name in order:
            if name == "contract" and not call("append"):
                raise RuntimeError("session_cycle: append before contract failed")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = call(name)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
            if name == "append" and ok:
                ok = call("contract")
            if not ok:
                raise RuntimeError(f"session_cycle: {name} failed")
    med = {f"{n}_ms": statistics.median(w) for n, w in walls.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"session_cycle": args.label, **med,
                      "refactor_over_cycle": med["refactor_ms"] / med["cycle_ms"],
                      "runs": walls, "card": smi}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
