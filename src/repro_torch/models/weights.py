"""Parameters of the reference, carried into the port.

The port keeps the reference's layouts (stacked ``[L, ...]`` leaves,
``wq [D, H, Dh]``, ``wo [H, Dh, D]``, a tied ``embed``), so the conversion
copies and never transposes. The reference's tree comes in as nested dicts
of arrays (``np.asarray`` of each leaf); nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: same bits
        # through a uint16 view
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def from_reference(params: dict, device=None) -> dict:
    """The reference parameter tree ``params`` as the port's, on ``device``
    (``None``: the card)."""
    dev = resolve_device(device)
    return {k: (from_reference(v, dev) if isinstance(v, dict)
                else _tensor(v).to(dev))
            for k, v in params.items()}
