"""opty_tpu_torch: the PyTorch/CUDA port of opty_tpu.

Direct-collocation trajectory optimization on an NVIDIA GPU: SymPy
dynamics lowered to batched torch residual, Jacobian and Hessian
kernels, and the filter interior-point solver over the structured KKT
system.  Its factorizations run in hand-written CUDA kernels: the
cyclic-reduction factor and downsweep (ops/pcr_kernels.py,
csrc/pcr.cu, and csrc/wide.cu for blocks up to d = 64), the scan
path's factor and solve (ops/scan_kernels.py, csrc/scan.cu) and the
block inverse and product (ops/block_kernels.py, csrc/blocks.cu).
Entry points run on the card unless the caller passes
``device='cpu'``.
Imports no JAX and nothing of opty_tpu.
"""

from . import config  # noqa: F401  (TF32 off; must come first)
from .version import __version__  # noqa: F401
from .problem import Problem  # noqa: F401
from .transcribe.collocator import ConstraintCollocator  # noqa: F401
from .utils import (  # noqa: F401
    create_objective_function, parse_free, state_derivatives, f_minus_ma,
    sum_of_sines, controllable, substitute_matrix, sort_sympy)
from .nlp import IPMOptions, solve_ipm  # noqa: F401
