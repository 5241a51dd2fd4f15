"""The engine's policy knobs (counterpart of capital_tpu/serve/engine.py).

Only `ServeConfig` is ported so far, as a copy of the reference dataclass
with the same fields and defaults.  The fields the batched bucket programs
read (`buckets`, `rows_buckets`, `nrhs_buckets`, `nblocks_buckets`,
`block_buckets`, `border_buckets`, `max_batch`, `precision`,
`small_n_impl`, `blocktri_impl`, `blocktri_partitions`) are validated on
construction.  `SolveEngine` waits for
ROADMAP Queue A item 8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from capital_tpu_torch.models import blocktri
from capital_tpu_torch.ops import batched_small
from capital_tpu_torch.robust.config import RobustConfig

#: precision names the models accept (CholinvConfig.precision)
PRECISIONS = (None, "default", "high", "highest")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine policy knobs (the reference's docstring has each in full).

    buckets: the n ladder (SPD dimension / lstsq columns).
    rows_buckets: the lstsq m ladder (requests bucket at m + column-pad).
    nrhs_buckets: the RHS-columns ladder.
    nblocks_buckets, block_buckets, border_buckets: the posv_blocktri /
        posv_arrowhead ladders (chain length, block size, border width).
    blocktri_impl: the chain algorithm of those programs ('auto', 'scan',
        'partitioned'); blocktri_partitions: its split count (0 = default).
    max_batch: per-bucket batch capacity — one program per bucket at this
        fixed batch size.
    max_delay_s: oldest-request age that forces a flush.
    precision: matmul precision inside the programs ('highest' is IEEE f32).
    robust: per-request breakdown flagging.
    donate, oversize, tail_fuse_depth, scheduler, max_inflight, persist_dir,
        factor_cache_bytes: engine knobs (Queue A item 8).
    small_n_impl: which batched implementation the bucket programs use
        (serve/api.batched): 'auto', 'vmap', 'pallas' or 'pallas_split'.
    """

    buckets: tuple[int, ...] = (256, 512, 1024)
    rows_buckets: tuple[int, ...] = (4096, 16384, 65536)
    nrhs_buckets: tuple[int, ...] = (1, 8, 64)
    nblocks_buckets: tuple[int, ...] = (8, 32, 64)
    block_buckets: tuple[int, ...] = (32, 64, 128)
    border_buckets: tuple[int, ...] = (8, 16, 32)
    blocktri_impl: str = "auto"
    blocktri_partitions: int = 0
    max_batch: int = 8
    max_delay_s: float = 0.005
    precision: Optional[str] = "highest"
    robust: Optional[RobustConfig] = None
    donate: Optional[bool] = None
    oversize: str = "models"
    small_n_impl: str = "auto"
    tail_fuse_depth: int = 0
    scheduler: str = "continuous"
    max_inflight: int = 2
    persist_dir: Optional[str] = None
    factor_cache_bytes: int = 256 << 20

    def __post_init__(self):
        for name in ("buckets", "rows_buckets", "nrhs_buckets", "nblocks_buckets",
                     "block_buckets", "border_buckets"):
            ladder = getattr(self, name)
            if (not isinstance(ladder, tuple) or not ladder
                    or not all(isinstance(v, int) and v >= 1 for v in ladder)):
                raise ValueError(
                    f"{name} must be a non-empty tuple of positive ints, got {ladder!r}"
                )
        if not isinstance(self.max_batch, int) or self.max_batch < 1:
            raise ValueError(f"max_batch must be an int >= 1, got {self.max_batch!r}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {self.precision!r}")
        if self.small_n_impl not in batched_small.IMPLS:
            raise ValueError(
                f"unknown small_n_impl {self.small_n_impl!r}: expected one "
                f"of {batched_small.IMPLS}"
            )
        if self.blocktri_impl not in blocktri.ALGORITHMS:
            raise ValueError(
                f"unknown blocktri_impl {self.blocktri_impl!r}: expected one of "
                f"{blocktri.ALGORITHMS}"
            )
        if not isinstance(self.blocktri_partitions, int) or self.blocktri_partitions < 0:
            raise ValueError(f"blocktri_partitions must be >= 0, got {self.blocktri_partitions!r}")
