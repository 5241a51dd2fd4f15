"""Runtime configuration enums (counterpart of capital_tpu/utils/config.py).

The reference selects its base-case policy by template instantiation
(cholinv<..., NoReplication>); here, as in the JAX package, it is a runtime
enum carried on the algorithm's config.
"""

from __future__ import annotations

import enum


class BaseCasePolicy(enum.Enum):
    """Base-case execution strategies (reference cholinv/policy.h:160-514).

    On one device every policy factors the leaf panel once on that device,
    so they coincide; the enum is kept so configurations carry across from
    the JAX package unchanged (utils/interop.config_from_fields).

      REPLICATE_COMM_COMP    every device factors the replicated panel
      REPLICATE_COMP         only the z=0 depth layer factors
      NO_REPLICATION         only the root device factors
      NO_REPLICATION_OVERLAP the same schedule, scatter overlapped with trtri
    """

    REPLICATE_COMM_COMP = 0
    REPLICATE_COMP = 1
    NO_REPLICATION = 2
    NO_REPLICATION_OVERLAP = 3

    @property
    def compute_scope(self) -> str:
        """Which devices run the panel factorization: 'all' | 'layer' |
        'root'."""
        if self is BaseCasePolicy.REPLICATE_COMM_COMP:
            return "all"
        if self is BaseCasePolicy.REPLICATE_COMP:
            return "layer"
        return "root"
