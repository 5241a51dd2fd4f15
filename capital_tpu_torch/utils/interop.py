"""State carried across from the JAX package.

This library holds no weights: what crosses over is operands, buffers and
configuration.  Operands cross as numpy arrays.  JAX hands bf16 out as
`ml_dtypes.bfloat16` arrays, which `torch.from_numpy` refuses, so bf16
travels as its raw 16-bit patterns — bitwise, never through a float.
Configurations cross as the field dict of `dataclasses.asdict()` of a JAX
`CholinvConfig`, `CacqrConfig`, `ServeConfig`, `RectriConfig`,
`NewtonConfig` or `TrsmConfig`, with enums and dtypes
mapped by name, so the port never imports the JAX classes.  A `RobustInfo` of either package
crosses as a dict of numpy scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from capital_tpu_torch.models.cholesky import CholinvConfig
from capital_tpu_torch.models.inverse import NewtonConfig, RectriConfig
from capital_tpu_torch.models.qr import CacqrConfig
from capital_tpu_torch.models.trsm import TrsmConfig
from capital_tpu_torch.robust.config import RobustConfig, RobustInfo
from capital_tpu_torch.serve.engine import ServeConfig
from capital_tpu_torch.utils.config import BaseCasePolicy


def tensor_from_numpy(a: np.ndarray, device: torch.device | str = "cpu") -> torch.Tensor:
    """A tensor on `device` holding `a`'s values; bf16 arrays keep their
    bits exactly (uint16 view, then a bf16 view)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of `t`.  bf16 comes back as its uint16 bit patterns; view
    the result as `ml_dtypes.bfloat16` where that package is at hand."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def dtype_from_name(x) -> torch.dtype:
    """torch dtype of a dtype given by name, numpy dtype or scalar type."""
    name = x if isinstance(x, str) else np.dtype(x).name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return dt


def config_from_fields(fields: dict) -> CholinvConfig:
    """The port's CholinvConfig from `dataclasses.asdict(jax_cfg)`."""
    kw = dict(fields)
    pol = kw.get("policy")
    if pol is not None and not isinstance(pol, BaseCasePolicy):
        kw["policy"] = BaseCasePolicy[getattr(pol, "name", pol)]
    if kw.get("base_case_dtype") is not None:
        kw["base_case_dtype"] = dtype_from_name(kw["base_case_dtype"])
    rob = kw.get("robust")
    if isinstance(rob, dict):
        kw["robust"] = RobustConfig(**rob)
    return CholinvConfig(**kw)


def cacqr_config_from_fields(fields: dict) -> CacqrConfig:
    """The port's CacqrConfig from `dataclasses.asdict(jax_cfg)`, nested
    `cholinv` and `robust` included."""
    kw = dict(fields)
    if isinstance(kw.get("cholinv"), dict):
        kw["cholinv"] = config_from_fields(kw["cholinv"])
    if isinstance(kw.get("robust"), dict):
        kw["robust"] = RobustConfig(**kw["robust"])
    return CacqrConfig(**kw)


def rectri_config_from_fields(fields: dict) -> RectriConfig:
    """The port's RectriConfig from `dataclasses.asdict(jax_cfg)`."""
    return RectriConfig(**fields)


def newton_config_from_fields(fields: dict) -> NewtonConfig:
    """The port's NewtonConfig from `dataclasses.asdict(jax_cfg)`."""
    return NewtonConfig(**fields)


def trsm_config_from_fields(fields: dict) -> TrsmConfig:
    """The port's TrsmConfig from `dataclasses.asdict(jax_cfg)`."""
    return TrsmConfig(**fields)


def serve_config_from_fields(fields: dict) -> ServeConfig:
    """The port's ServeConfig from `dataclasses.asdict(jax_cfg)`, `robust`
    as a RobustConfig."""
    kw = dict(fields)
    if isinstance(kw.get("robust"), dict):
        kw["robust"] = RobustConfig(**kw["robust"])
    return ServeConfig(**kw)


#: numpy dtype of each RobustInfo field (both packages)
_ROBUST_INFO_DTYPES = {
    "info": np.int32, "breakdown": np.int32, "shifted": np.int32, "sigma": np.float32,
    "escalated": np.int32, "ortho": np.float32, "gate": np.int32,
}


def robust_info_to_numpy(ri) -> dict:
    """{field: numpy scalar} of a RobustInfo from either package (torch
    tensors, JAX arrays or Python numbers), so two can be compared field by
    field."""
    out = {}
    for name in RobustInfo._fields:
        v = getattr(ri, name)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[name] = np.asarray(v).astype(_ROBUST_INFO_DTYPES[name])[()]
    return out
