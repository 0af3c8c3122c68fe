"""SymPy -> PyTorch lowering.

The counterpart of opty_tpu/symbolics/lower.py: the *continuous*
equations of motion are lowered once into a scalar torch kernel;
discretization, the node loop (``torch.func.vmap``) and
differentiation (``jacfwd``/``jacrev``/``hessian``) are transforms
applied downstream.  The CSE settings are the JAX package's, so both
lower the same expressions to the same operation sequence.
"""

import sympy as sm
import torch
from sympy.printing.pytorch import TorchPrinter

__all__ = ['lambdify_torch']


def _cse(exprs, **kwargs):
    return sm.cse(exprs, symbols=sm.numbered_symbols('_z'), order='none',
                  **kwargs)


def _safe_tanh(x):
    # tanh saturates to +-1 within one float64 ulp for |x| > 40, so the
    # clamp is exact; it is kept from the JAX package (whose emulated
    # float64 overflowed for large |x|) so both lower to the same values.
    return torch.tanh(torch.clamp(x, -40.0, 40.0))


_TORCH_OVERRIDES = {'tanh': _safe_tanh}


class _CodePrinter(TorchPrinter):
    """SymPy's torch printer with two additions: a function that knows
    how to print itself (the musculotendon curves of
    ``sympy.physics.biomechanics``, ``_print_code``) is printed as the
    other code printers do, from its unevaluated definition; and a
    function or power of numbers alone (``sqrt(2)``, which torch's
    functions refuse as a Python number) is printed as its float64
    value."""

    def _constant(self, expr):
        return repr(float(sm.N(expr, 30)))

    def _print_Function(self, expr):
        if expr.is_number:
            return self._constant(expr)
        if type(expr) not in self.mapping and hasattr(expr, '_print_code'):
            return expr._print_code(self)
        return super()._print_Function(expr)

    def _print_Pow(self, expr):
        if expr.is_number:
            return self._constant(expr)
        return super()._print_Pow(expr)


def _default_printer():
    """The printer ``lambdify`` would make for the torch namespace,
    with ``_CodePrinter``'s addition."""
    return _CodePrinter({
        'fully_qualified_modules': False, 'inline': True,
        'allow_unknown_functions': True,
        'user_functions': {k: k for k in _TORCH_OVERRIDES}})


def _as_tensor_like(v, ref):
    """A lowered output that is a Python number (a constant entry)
    becomes a 0-d tensor with ``ref``'s dtype and device, so the
    outputs stack under ``torch.func.vmap``."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), float(v), dtype=ref.dtype, device=ref.device)


def lambdify_torch(args, exprs, use_cse=True, printer=None):
    """Lower SymPy expressions to a torch scalar function.

    ``fn(*values) -> tensor of shape (len(exprs),)`` where each value is
    a 0-d tensor (or a vmapped one).  Safe under every ``torch.func``
    transform.  ``printer`` replaces SymPy's torch printer.
    """
    exprs = list(exprs)
    cse_fn = _cse if use_cse else None
    raw = sm.lambdify(tuple(args), exprs,
                      modules=[_TORCH_OVERRIDES, 'torch'],
                      printer=printer or _default_printer(),
                      cse=cse_fn, docstring_limit=0)

    def fn(*values):
        out = raw(*values)
        ref = next(v for v in values if isinstance(v, torch.Tensor))
        return torch.stack([_as_tensor_like(v, ref) for v in out])

    fn._sympy_source = raw
    return fn
