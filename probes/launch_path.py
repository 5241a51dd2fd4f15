"""Host cost of one transpose launch, piece by piece, on the card's host.

    python3 probes/launch_path.py

Times (perf_counter over many calls, no synchronisation inside) each step
that `hopper.transpose` takes at the cholinv leaf read (a 512 x 512 bf16
window to an f32 lower panel) — the stream handle by each public route,
the output allocation, the ctypes call, the whole wrapper — beside
`copy_` of the window's transpose, and prints one JSON line of
microseconds per call.  Then the parent's launch path (the stream handle
through `torch.cuda.current_stream()`, the ctypes entry looked up on every
call) against this tree's, interleaved in this one process (new, old, old,
new, three times): the per-call wall of `transpose` and `transpose_pair`
(CUDA events around 200 back-to-back calls) and their host time, one JSON
line, microseconds per call.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from capital_tpu_torch.ops import _build, hopper  # noqa: E402


def us(fn, n: int = 20000) -> float:
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    t = (time.perf_counter_ns() - t0) / n / 1e3
    torch.cuda.synchronize()
    return t


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_path: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _build.build()
    dev = torch.device("cuda")
    buf = torch.randn(1024, 1024, device=dev).to(torch.bfloat16)
    panel = torch.empty((512, 512), device=dev)
    win = buf[512:, 512:]
    kw = dict(in_view=(512, 512, 512, 512), out_uplo="L", out_dtype=torch.float32)
    fn = _build.entry("capital_transpose")
    raw = torch.cuda.current_stream().cuda_stream
    iv = (512, 512, 512, 512)
    res = {
        "hopper._stream()": us(hopper._stream),
        "_transpose_spec": us(lambda: hopper._transpose_spec(buf, iv, "L", None, (0, 0))),
        "_kernel_operand": us(lambda: hopper._kernel_operand(buf, "X")),
        "_ptr": us(lambda: hopper._ptr(buf, 512, 512)),
        "_build.entry": us(lambda: _build.entry("capital_transpose")),
        "_launched": us(lambda: hopper._launched(0, hopper.KERNELS["transpose"])),
        "cuda.current_stream().cuda_stream": us(lambda: torch.cuda.current_stream().cuda_stream),
        "cuda.current_stream(0).cuda_stream": us(lambda: torch.cuda.current_stream(0).cuda_stream),
        "new_empty 512x512 f32": us(lambda: buf.new_empty((512, 512), dtype=torch.float32)),
        "torch.empty device=": us(lambda: torch.empty((512, 512), dtype=torch.float32, device=buf.device)),
        "ctypes launch": us(lambda: fn(0, 1, hopper._ptr(buf, 512, 512), 1024, panel.data_ptr(), 512,
                                       512, 512, 2, raw), 5000),
        "transpose wrapper": us(lambda: hopper.transpose(buf, **kw), 5000),
        "copy_ of .t()": us(lambda: panel.copy_(win.t()), 5000),
        "data_ptr": us(lambda: buf.data_ptr()),
        "_on_card": us(lambda: hopper._on_card(buf, None)),
    }
    acc = getattr(torch, "accelerator", None)
    if acc is not None and hasattr(acc, "current_stream") and hasattr(torch.Stream, "native_handle"):
        res["accelerator.current_stream().native_handle"] = us(lambda: acc.current_stream().native_handle)
        res["native_handle == cuda_stream"] = acc.current_stream().native_handle == raw
    # the per-call wall chip_smoke.py reports: CUDA events around 200
    # back-to-back calls
    for name, fn in (("transpose", lambda: hopper.transpose(buf, **kw)), ("copy_", lambda: panel.copy_(win.t()))):
        fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(200):
            fn()
        e.record()
        e.synchronize()
        res[f"{name} wall, CUDA events"] = s.elapsed_time(e) / 200 * 1e3
    print(json.dumps({"torch": torch.__version__, "us_per_call": res}), flush=True)
    print(json.dumps({"old_vs_new_us_per_call": old_vs_new(buf, kw)}), flush=True)
    return 0


def old_entry(name: str):
    """`_build.entry` before it memoized: the library attribute every call."""
    return getattr(_build._STATE.libs[_build.SIGNATURES[name][0]], name)


def old_stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def events_us(fn, n: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n * 1e3


def old_vs_new(buf, kw) -> dict:
    """Each wrapper's wall (CUDA events) and host time (perf_counter) under
    the old and the new launch path, interleaved; the mean of three rounds
    and every round."""
    L = torch.tril(torch.randn(512, 512, device=buf.device))
    Li = torch.tril(torch.randn(512, 512, device=buf.device))
    Rp, RIp = torch.zeros_like(buf), torch.zeros_like(buf)
    calls = {"transpose": lambda: hopper.transpose(buf, **kw),
             "transpose_pair": lambda: hopper.transpose_pair(L, Li, Rp, RIp, dest=512)}
    paths = {"new": (_build.entry, hopper._stream), "old": (old_entry, old_stream)}
    runs = {f"{c} {p} {m}": [] for c in calls for p in paths for m in ("wall", "host")}
    try:
        for path in ["new", "old", "old", "new"] * 3:
            _build.entry, hopper._stream = paths[path]
            for c, fn in calls.items():
                runs[f"{c} {path} wall"].append(events_us(fn))
                runs[f"{c} {path} host"].append(us(fn, 5000))
    finally:
        _build.entry, hopper._stream = paths["new"]
    return {"mean": {k: sum(v) / len(v) for k, v in runs.items()}, "runs": runs}


if __name__ == "__main__":
    sys.exit(main())
