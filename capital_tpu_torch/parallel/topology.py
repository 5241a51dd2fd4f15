"""Device topology (counterpart of capital_tpu/parallel/topology.py:Grid).

This slice runs on one device: a `Grid` holds one `torch.device`.  The
reference's d x d x c meshes (and the JAX package's multi-device shapes)
raise NotImplementedError until the port's multi-device item lands
(ROADMAP Queue A item 10).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Grid:
    """A 1 x 1 x 1 grid on one `torch.device`."""

    device: torch.device

    @staticmethod
    def square(c: int = 1, device: torch.device | str | None = None) -> "Grid":
        """One-device square grid.  With no `device` the grid is the CUDA
        card, and a machine without one raises: there is no quiet CPU
        fallback — tests ask for `device="cpu"` explicitly."""
        if c != 1:
            raise NotImplementedError(
                f"Grid.square(c={c}): only the single-device grid is ported "
                "(ROADMAP Queue A item 10, multi-device)"
            )
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Grid.square(): no CUDA device; pass device='cpu' to run "
                    "the plain PyTorch path on the host"
                )
            device = "cuda"
        return Grid(device=torch.device(device))

    @property
    def dx(self) -> int:
        return 1

    @property
    def dy(self) -> int:
        return 1

    @property
    def c(self) -> int:
        return 1

    @property
    def num_devices(self) -> int:
        return 1

    @property
    def platform(self) -> str:
        """'cuda' or 'cpu' — the type of the grid's device."""
        return self.device.type

    def pin(self, x: torch.Tensor) -> torch.Tensor:
        """Layout pin: a no-op on one device."""
        return x
