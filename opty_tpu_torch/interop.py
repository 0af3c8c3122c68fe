"""Carry solver values between opty_tpu and opty_tpu_torch.

Nothing here imports JAX: values cross as dicts of numpy arrays, e.g.
``{k: np.asarray(v) for k, v in state._asdict().items()}`` for an
opty_tpu ``IPMState``.  The parity tests start both solvers from one
identical state this way.
"""

import numpy as np
import torch

from .config import resolve_device
from .nlp.ipm_types import IPMResult, IPMState

__all__ = ['state_from_numpy', 'result_to_numpy']


def state_from_numpy(d, device=None):
    """An ``IPMState`` of tensors on ``device`` (None: the card) from a
    dict of numpy arrays keyed by the IPMState fields.  The lane axis is
    optional: a single-instance state (``x`` of shape (n,)) gets a lane
    axis of 1."""
    device = resolve_device(device)
    single = np.asarray(d['x']).ndim == 1
    fields = {}
    for name in IPMState._fields:
        a = np.array(d[name])          # a writable copy
        if single:
            a = a[None]
        if a.dtype.kind == 'f':
            a = a.astype(np.float64)
        elif a.dtype.kind in 'iu':
            a = a.astype(np.int32)
        fields[name] = torch.as_tensor(a, device=device)
    return IPMState(**fields)


def result_to_numpy(res):
    """A dict of numpy arrays keyed by the IPMResult fields."""
    return {name: np.asarray(torch.as_tensor(v).detach().cpu().numpy())
            for name, v in zip(IPMResult._fields, res)}
