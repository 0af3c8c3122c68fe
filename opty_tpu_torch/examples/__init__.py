"""The JAX package's examples, ported: the two parameter-identification
examples (a ``build_problem`` returning the problem, its initial guess
and the true values, and a ``main`` with the original's arguments), the
pendulum swing-up, the n-link reach and the gallery (``gallery``, 25
problems).  Run one with ``python -m opty_tpu_torch.examples.<name>``
(on the card)."""
