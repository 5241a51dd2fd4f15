"""Device topology (counterpart of capital_tpu/parallel/topology.py).

A `Grid` is a dx x dy x c grid of ranks — face dx x dy, replication depth
c — the reference's process grids (topo::square / topo::rect).  Each rank
has a `torch.device`; the rank -> (x, y, z) assignment is the reference's
`layout` knob (`_order_devices`).

The port runs the **virtual mesh**: every rank on one device, the way the
JAX package runs its multi-device programs on virtual CPU devices.  The
explicit SUMMA schedule then runs rank by rank in one process and each
collective is a copy or a sum on that device (parallel/mesh.py).  Ranks on
distinct devices need a `torch.distributed` backend of parallel/mesh.py and
raise NotImplementedError (ROADMAP Queue A item 10).

Distributed matrices are global tensors on the grid's device; the
P('x', 'y') block cut happens inside the explicit schedule
(`mesh.blocks`), as the reference's shard_map cuts its global arrays.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

AXES = ("x", "y", "z")
#: what a grid of ranks on distinct devices waits for
NCCL_ITEM = ("ROADMAP Queue A item 10: a torch.distributed / NCCL backend of "
             "parallel/mesh.py for ranks on distinct devices")


def _infer_square_face(num_devices: int, c: int) -> int:
    """d = sqrt(P / c), the face dimension of a d x d x c grid; P must be
    exactly divisible (the reference's messages)."""
    if num_devices % c != 0:
        raise ValueError(f"num_devices={num_devices} not divisible by c={c}")
    face = num_devices // c
    d = int(round(math.sqrt(face)))
    if d * d != face:
        raise ValueError(
            f"num_devices/c = {face} is not a perfect square; "
            f"cannot build a d x d x {c} grid from {num_devices} devices"
        )
    return d


def layout2_eligible(dx: int, dy: int, c: int) -> bool:
    """Whether the 2x2x2-subcube ordering (layout=2) applies to this shape."""
    return dx % 2 == 0 and dy % 2 == 0 and c % 2 == 0


def _order_devices(devices: Sequence, dx: int, dy: int, c: int, layout: int) -> np.ndarray:
    """Assign the sequence (devices or rank numbers) to (x, y, z) grid
    coordinates: the reference's layouts.

      0  depth-fastest: the natural reshape (dx, dy, c);
      1  face-fastest: consecutive entries tile the d x d face first;
      2  consecutive groups of 8 form 2x2x2 subcubes; falls back to layout
         0, with a warning, when a dimension is odd.
    """
    dev = np.empty(len(devices), dtype=object)
    dev[:] = list(devices)
    if layout == 0:
        return dev.reshape(dx, dy, c)
    if layout == 1:
        return np.moveaxis(dev.reshape(c, dx, dy), 0, 2)
    if layout == 2:
        if not layout2_eligible(dx, dy, c):
            warnings.warn(
                f"layout=2 needs even grid dims, got {(dx, dy, c)}: "
                "falling back to layout 0 (a layout-0-vs-2 comparison on "
                "this grid would silently measure the same ordering)",
                stacklevel=3,
            )
            return dev.reshape(dx, dy, c)
        return (
            dev.reshape(dx // 2, dy // 2, c // 2, 2, 2, 2)
            .transpose(0, 3, 1, 4, 2, 5)
            .reshape(dx, dy, c)
        )
    raise ValueError(f"layout must be 0, 1, or 2, got {layout}")


def _devices(devices, device) -> list[torch.device]:
    """The ranks' devices: `devices`, else [device], else the CUDA card
    (raising without one — tests ask for device='cpu' explicitly)."""
    if devices is not None and device is not None:
        raise ValueError("pass devices= or device=, not both")
    if devices is not None:
        return [torch.device(d) for d in devices]
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "Grid: no CUDA device; pass device='cpu' to run the plain "
                "PyTorch path on the host"
            )
        device = "cuda"
    return [torch.device(device)]


@dataclasses.dataclass(frozen=True)
class Grid:
    """A dx x dy x c grid of ranks on one `torch.device`.

    coords[r] is rank r's (x, y, z), in the constructor's `layout`.
    num_chunks (0/1 unchunked) splits the explicit schedule's K-slices and
    depth collect into that many pieces.  collective_concurrency: 'free' or
    'solo'; the virtual mesh issues its collectives one at a time, so both
    run alike here."""

    device: torch.device
    dx: int = 1
    dy: int = 1
    c: int = 1
    coords: tuple[tuple[int, int, int], ...] = ((0, 0, 0),)
    num_chunks: int = 0
    collective_concurrency: str = "free"

    @staticmethod
    def _build(devices, dx, dy, c, layout, num_chunks, collective_concurrency) -> "Grid":
        if len(set(devices)) > 1:
            raise NotImplementedError(
                f"a grid over the distinct devices {sorted(map(str, set(devices)))} "
                f"is not ported yet ({NCCL_ITEM})"
            )
        ranks = _order_devices(range(len(devices)), dx, dy, c, layout)
        coords = [None] * len(devices)
        for xyz in np.ndindex(dx, dy, c):
            coords[ranks[xyz]] = tuple(int(v) for v in xyz)
        return Grid(device=devices[0], dx=dx, dy=dy, c=c, coords=tuple(coords),
                    num_chunks=num_chunks, collective_concurrency=collective_concurrency)

    @staticmethod
    def square(
        c: int = 1,
        devices: Optional[Sequence] = None,
        layout: int = 0,
        num_chunks: int = 0,
        collective_concurrency: str = "free",
        device: torch.device | str | None = None,
    ) -> "Grid":
        """A d x d x c grid over `devices` (one per rank), or over the one
        `device` (default: the CUDA card)."""
        devs = _devices(devices, device)
        d = _infer_square_face(len(devs), c)
        return Grid._build(devs, d, d, c, layout, num_chunks, collective_concurrency)

    @staticmethod
    def rect(
        dx: int,
        dy: int,
        c: int = 1,
        devices: Optional[Sequence] = None,
        layout: int = 0,
        num_chunks: int = 0,
        collective_concurrency: str = "free",
    ) -> "Grid":
        """A dx x dy x c grid (the reference's topo::rect)."""
        devs = _devices(devices, None)
        if dx * dy * c != len(devs):
            raise ValueError(f"{dx}*{dy}*{c} != {len(devs)} devices")
        return Grid._build(devs, dx, dy, c, layout, num_chunks, collective_concurrency)

    @staticmethod
    def flat(devices: Optional[Sequence] = None) -> "Grid":
        """A P x 1 x 1 grid: every rank along 'x'."""
        devs = _devices(devices, None)
        return Grid._build(devs, len(devs), 1, 1, 0, 0, "free")

    @property
    def num_devices(self) -> int:
        """The number of ranks."""
        return self.dx * self.dy * self.c

    @property
    def platform(self) -> str:
        """'cuda' or 'cpu' — the type of the grid's device."""
        return self.device.type
