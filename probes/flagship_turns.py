"""The blocktri flagship and the Spike flagship on each of their routes,
timed in turns, for one tree of the port.

    python3 probes/flagship_turns.py [--root DIR] [--rounds N] [--label NAME]

Imports `capital_tpu_torch` from DIR (default: this checkout), so that two
trees — a parent commit unpacked into a git-ignored directory of the
checkout, and the checkout itself — run the same timing in separate
processes of one chip call, in the order parent, change, change, parent.
The timing helpers and operands are this checkout's `chip_smoke.py`
(`chain_operands`, seed 12; `turns_s`; `complete_profile`).  Prints the
card's name and power limit and one JSON line: for the flagship (64 blocks
of 128, one problem, one RHS: 'pallas', 'auto', 'xla') and the Spike
flagship (64 blocks of 16, two problems, two RHS: 'pallas', 'partitioned',
'xla'), each route's median of N readings in turns (ms, three calls a
reading) and one complete profile's idle share and device-busy ms.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--label", default="")
    opts = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke  # noqa: E402  (before the tree under test, so its helpers are this checkout's)

    sys.path.insert(0, str(Path(opts.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("flagship_turns: no CUDA device", file=sys.stderr)
        return 2
    from capital_tpu_torch.models import blocktri
    from capital_tpu_torch.ops import _build

    assert Path(blocktri.__file__).resolve().is_relative_to(Path(opts.root).resolve()), blocktri.__file__
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda")
    out = {"label": opts.label, "root": opts.root}
    for name, (nb, b, batch, k), impls in (("b128", chip_smoke.BT_FLAGSHIP, ("pallas", "auto", "xla")),
                                           ("b16", chip_smoke.BT_SPIKE, ("pallas", "partitioned", "xla"))):
        D, C, B = chip_smoke.chain_operands(batch, nb, b, k, 12, dev)
        runs = {impl: (lambda impl=impl: blocktri.posv(D, C, B, impl=impl)) for impl in impls}
        for run in runs.values():
            run()
        t = chip_smoke.turns_s(runs, opts.rounds, 3)
        row = {}
        for impl in impls:
            prof = chip_smoke.complete_profile(runs[impl], "BT::")
            row[impl] = dict(median_ms=t[impl]["median"] * 1e3, runs_ms=[x * 1e3 for x in t[impl]["runs"]],
                             idle_share=prof["idle_share"], device_busy_ms=prof["device_busy_ms"],
                             records_lost=prof["records_lost"])
        out[name] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
