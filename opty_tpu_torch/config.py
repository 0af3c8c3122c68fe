"""Global configuration for opty_tpu_torch.

The collocation NLPs are solved to Ipopt-level tolerances (1e-8), so
the solver core works in float64 on every device.  The KKT
factorization runs in ``factor_dtype`` and recovers float64 accuracy
through iterative refinement against the float64 operator.

Defaults are chosen by the device type, never by probing a backend, and
follow the JAX package's (opty_tpu/config.py):

* ``cpu``: ``kkt_method='scan'`` (the sequential block elimination of
  nlp/kkt.py, lowest flops) with a float64 factorization and one
  refinement round — the float64 reference path;
* ``cuda``: ``kkt_method='cr'`` (parallel cyclic reduction through the
  hand-written CUDA kernels of ops/pcr_kernels.py) with a float32
  factorization and 6 rounds of float64 refinement.  The scan path runs
  on the card too (its block inverses and products through
  ops/block_kernels.py), in float64 natively.

Entry points take ``device=None``, which means ``cuda``.  Without a
card they raise instead of falling back to the CPU; callers that want
the CPU pass ``device='cpu'``.
"""

import torch

__all__ = ['default_dtype', 'resolve_device', 'default_factor_dtype',
           'default_kkt_method']

# A float32 matrix product must be a true float32 product: TF32 keeps
# ~10 mantissa bits, and the float32 KKT factorizations (chains of
# small block products whose error compounds across the node axis)
# lose all accuracy with it — the reason the JAX package forces
# 'highest' matmul precision on its accelerator.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')


def default_dtype():
    """Residual/gradient working dtype."""
    return torch.float64


def resolve_device(device=None):
    """``None`` means the card.  Raises when no card is present and the
    caller did not ask for the CPU explicitly."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'opty_tpu_torch runs on a CUDA device by default and none is '
            "available; pass device='cpu' to run on the CPU.")
    return dev


def default_factor_dtype(device):
    """float32 factorization on the card (refined in float64), float64
    on the CPU."""
    return torch.float32 if torch.device(device).type == 'cuda' \
        else default_dtype()


def default_kkt_method(device):
    """'cr' on the card (log-depth), 'scan' on the CPU."""
    return 'cr' if torch.device(device).type == 'cuda' else 'scan'
