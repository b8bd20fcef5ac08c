"""Stacked numpy scan fields -> the reference's ``ScanInput`` on a
device, in the configuration's dtype (one copy a field)."""

from __future__ import annotations

import numpy as np
import torch

from .pipeline import ScanInput


def scan_inputs(fields: dict, dtype, device) -> ScanInput:
    return ScanInput(**{k: torch.as_tensor(np.asarray(fields[k]),
                                           dtype=dtype).to(device)
                        for k in ScanInput._fields})
