"""Cell-center (layer) -> cell-interface (level) interpolation (PyTorch port
of ``pyharp_tpu/interp/layer2level.py``).

Same stencils as the reference: the 4th-order compact interior stencil
``(-1/12, 7/12, 7/12, -1/12)``, the 2nd-order midpoint variant, and the
extrapolate/constant boundary modes.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

k2ndOrder = 2
k4thOrder = 4

kExtrapolate = 0
kConstant = 1


@dataclasses.dataclass(frozen=True)
class Layer2LevelOptions:
    order: int = k4thOrder
    logx: bool = False
    logy: bool = False
    blower: int = kExtrapolate
    bupper: int = kConstant
    check_positivity: bool = True


def layer2level(var: Tensor,
                options: Layer2LevelOptions = Layer2LevelOptions()) -> Tensor:
    """Interpolate layer values ``(..., nlyr)`` to levels ``(..., nlyr+1)``.

    ``check_positivity`` is accepted and, as in the JAX package, not acted
    on here (the check would force a device-to-host sync).
    """
    if options.logy:
        var = torch.log(var)

    nlyr = var.shape[-1]
    parts = []

    if nlyr == 1:
        lo = var[..., 0]
    elif options.blower == kExtrapolate:
        lo = (3.0 * var[..., 0] - var[..., 1]) / 2.0
    elif options.blower == kConstant:
        lo = var[..., 0]
    else:
        raise ValueError("Unsupported lower boundary condition")
    parts.append(lo[..., None])

    if nlyr > 1:
        if options.order == k4thOrder:
            mid = (var[..., :-1] + var[..., 1:]) / 2.0
            if nlyr > 3:
                cm = (-1.0 / 12.0, 7.0 / 12.0, 7.0 / 12.0, -1.0 / 12.0)
                windows = (cm[0] * var[..., 0:nlyr - 3]
                           + cm[1] * var[..., 1:nlyr - 2]
                           + cm[2] * var[..., 2:nlyr - 1]
                           + cm[3] * var[..., 3:nlyr])
                mid = torch.cat([mid[..., :1], windows, mid[..., -1:]], dim=-1)
            parts.append(mid)
        elif options.order == k2ndOrder:
            parts.append((var[..., :-1] + var[..., 1:]) / 2.0)
        else:
            raise ValueError("Unsupported interpolation order")

    if nlyr == 1:
        hi = var[..., -1]
    elif options.bupper == kExtrapolate:
        hi = (3.0 * var[..., -1] - var[..., -2]) / 2.0
    elif options.bupper == kConstant:
        hi = var[..., -1]
    else:
        raise ValueError("Unsupported upper boundary condition")
    parts.append(hi[..., None])

    out = torch.cat(parts, dim=-1)
    if options.logy:
        out = torch.exp(out)
    return out


def layer2level_with_mask(var: Tensor,
                          options: Layer2LevelOptions = Layer2LevelOptions()
                          ) -> tuple[Tensor, Tensor]:
    """:func:`layer2level` and the mask of negative level values, which the
    caller checks (the reference aborts on them, ``layer2level.cpp:68-77``)."""
    out = layer2level(var, options)
    return out, out < 0
