"""Solver status codes.

Mirrors the subset of Ipopt return codes that the reference surfaces
through cyipopt (opty/direct_collocation.py:290-311 documents the
``info['status']``/``info['status_msg']`` contract; gallery examples
branch on ``status in (0, 1)``).
"""

SOLVE_SUCCEEDED = 0
SOLVED_TO_ACCEPTABLE_LEVEL = 1
INFEASIBLE_PROBLEM_DETECTED = 2
MAXIMUM_ITERATIONS_EXCEEDED = -1
RESTORATION_FAILED = -2
INVALID_NUMBER_DETECTED = -13

STATUS_MESSAGES = {
    SOLVE_SUCCEEDED: (b'Algorithm terminated successfully at a locally '
                      b'optimal point, satisfying the convergence tolerances '
                      b'(can be specified by options).'),
    SOLVED_TO_ACCEPTABLE_LEVEL: (b'Algorithm stopped at a point that was '
                                 b'converged, not to "desired" tolerances, '
                                 b'but to "acceptable" tolerances (see the '
                                 b'acceptable-... options).'),
    INFEASIBLE_PROBLEM_DETECTED: (b'Algorithm converged to a point of local '
                                  b'infeasibility. Problem may be '
                                  b'infeasible.'),
    MAXIMUM_ITERATIONS_EXCEEDED: b'Maximum number of iterations exceeded '
                                 b'(can be specified by an option).',
    RESTORATION_FAILED: b'Restoration phase failed, algorithm doesn\'t know '
                        b'how to proceed.',
    INVALID_NUMBER_DETECTED: (b'Algorithm received an invalid number (such '
                              b'as NaN or Inf) from the NLP; see also option '
                              b'check_derivatives_for_naninf.'),
}
