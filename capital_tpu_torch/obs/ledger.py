"""The versioned JSONL run ledger, the writers only (counterpart of
capital_tpu/obs/ledger.py).

One record per run: a manifest (schema_version, device, platform, grid,
dtype, the config dataclass dump) plus the run's blocks — the serve tier
appends ``serve:request_stats`` (serve/stats.Collector.emit) and
``serve:trace`` (obs/spans.TraceLog.emit) records.  The layout is the
reference's, key for key, so the reference's validators
(`validate_request_stats`, `validate_serve_trace`) read the port's records
as they are.  Where the reference's manifest records jax and its first
device, the port's records torch, its CUDA version and the card's name.
The validators and `diff` wait for ROADMAP Queue A item 9.

torch is imported where a manifest is written, not at module import, so
the host-only serve modules (telemetry windows, the router's records)
read `SCHEMA_VERSION` without loading it.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Any, Optional

#: Bump on any breaking change to the record layout (the reference's value:
#: the two packages' records share one schema).
SCHEMA_VERSION = 1


def _jsonable(obj: Any) -> Any:
    """Best-effort JSON coercion for config dataclass dumps: enums by name,
    dtypes/callables/devices by str."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            "__class__": type(obj).__name__,
            **{f.name: _jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)},
        }
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)


def _device_of(grid):
    import torch

    if grid is not None:
        return grid.device
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def manifest(grid=None, dtype=None, config=None, **extra) -> dict:
    """The run manifest: everything needed to decide whether two records
    are comparable, plus the config that produced the run.  The device is
    the grid's (the CUDA card when there is one and no grid is given)."""
    import torch

    dev = _device_of(grid)
    cuda = dev.type == "cuda"
    man = {
        "schema_version": SCHEMA_VERSION,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": dev.type,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "num_devices": torch.cuda.device_count() if cuda else 1,
        "grid": repr(grid) if grid is not None else None,
        "dtype": str(dtype).replace("torch.", "") if dtype is not None else None,
        "config": _jsonable(config) if config is not None else None,
    }
    if grid is not None:
        man["grid_shape"] = [grid.dx, grid.dy, grid.c]
    man.update(_jsonable(extra))
    return man


def record(kind: str, man: dict, *, model: Optional[dict] = None, audit: Optional[dict] = None,
           drift: Optional[dict] = None, measured: Optional[dict] = None,
           residuals: Optional[dict] = None, **extra) -> dict:
    """Assemble one ledger record.  `man` comes from manifest(); the other
    blocks are the reference's (model costs, program audit, drift, the
    measured JSON line, residual gates), None where a run has none."""
    rec = {
        "record": "capital_tpu.ledger",
        "kind": kind,
        "manifest": man,
        "model": model,
        "audit": audit,
        "drift": drift,
        "measured": measured,
        "residuals": residuals,
    }
    rec.update(_jsonable(extra))
    return rec


def append(path: str, rec: dict) -> None:
    """Append one record as a JSON line (creating parent dirs)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def read(path: str) -> list[dict]:
    """Load every record of a JSONL ledger (blank lines skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
