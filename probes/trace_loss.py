"""Which kernel records a torch.profiler trace loses late in a long process.

    python3 probes/trace_loss.py

Runs the whole `chip_smoke.py` in this process with its `device_ms` replaced
by `dev_ms` here, which takes the trace itself and writes, for every trace,
the host's kernel launch calls (`cudaLaunchKernel` and kin, by name), every
device record kept (start, end in ms after the trace began, name) and the
timed window, one JSON line each, to chiprun_out/trace_loss.jsonl.  Then, in
the same process, traces five calls of each chain factor step at
8 x 8 x 128 x 1 f32 three times with each of four settings of the sleep
before the timed calls and of a sleep plus a tiny kernel after them, and
prints whether each trace kept all five launches (`device_ms` not None).
"""

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

OUT = Path("chiprun_out") / "trace_loss.jsonl"
LOG = None


def trace(run, lead=0.05, tail=0.0):
    """One traced call of `run` after chip_smoke.profile's warm-ups and a
    `lead` s sleep; with `tail`, a sleep and a tiny kernel after it."""
    from torch.profiler import ProfilerActivity, profile

    from capital_tpu_torch.ops import hopper
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        torch.ones(1, device="cuda").add_(1)
        hopper.zeros_dead_lower(256, torch.float32, 128, device="cuda")
        torch.cuda.synchronize()
        time.sleep(lead)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if tail:
            time.sleep(tail)
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        te = time.perf_counter()
    spans, cpu = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.time_range.end > e.time_range.start:
                spans.append((e.time_range.start / 1e3, e.time_range.end / 1e3, e.name[:40]))
        elif "aunch" in e.name:
            cpu[e.name] = cpu.get(e.name, 0) + 1
    spans.sort()
    return dict(run_ms=[(t0 - ts) * 1e3, (t1 - ts) * 1e3], end_ms=(te - ts) * 1e3,
                spans=[(round(s, 3), round(e, 3), n) for s, e, n in spans], cpu_launch=cpu)


def result(d, iters):
    """chip_smoke.device_ms's rule of PR 15 (kernels seen at least
    iters - 1 times) on the dumped trace."""
    kern, n = {}, {}
    for s, e, name in d["spans"]:
        kern[name] = kern.get(name, 0.0) + (e - s)
        n[name] = n.get(name, 0) + 1
    kept = [(ms, n[k]) for k, ms in kern.items() if n[k] >= iters - 1]
    return sum(ms / seen * max(1, round(seen / iters)) for ms, seen in kept) if kept else None


def dev_ms(run, iters, lead=0.05, tail=0.0, tag="smoke"):
    d = trace(lambda: [run() for _ in range(iters)], lead, tail)
    r = result(d, iters)
    LOG.write(json.dumps({"where": tag, "iters": iters, "lead": lead, "tail": tail, "result": r, **d}) + "\n")
    LOG.flush()
    return r


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_loss: no CUDA device", file=sys.stderr)
        return 2
    global LOG
    OUT.parent.mkdir(exist_ok=True)
    LOG = open(OUT, "w")
    cs.device_ms = dev_ms
    rc = cs.main([])
    print("smoke rc", rc, flush=True)

    from capital_tpu_torch.ops import blocktri_small

    dev = torch.device("cuda")
    D, C, B, Lc, yc = cs.bt_operands(8, 8, 128, 1, torch.float32, 60, dev)
    for lead, tail in ((0.05, 0.0), (0.05, 0.05), (0.2, 0.0), (0.2, 0.2)):
        for rep in range(3):
            for name, fn in (("fused", lambda: blocktri_small.fused_forward_step(D, C, B, Lc, yc)),
                             ("factor", lambda: blocktri_small.factor_step(D, C, Lc))):
                r = dev_ms(fn, 5, lead, tail, tag=f"after {name} {rep}")
                print(json.dumps({"after": name, "lead": lead, "tail": tail, "rep": rep, "device_ms": r}),
                      flush=True)
    LOG.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
