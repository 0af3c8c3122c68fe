"""The JAX package's parameter-identification examples, ported: each
module has a builder (the problem, its initial guess and the true
values) and a ``main`` with the original's arguments, run with
``python -m opty_tpu_torch.examples.<name>`` (on the card)."""
