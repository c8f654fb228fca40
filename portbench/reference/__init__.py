"""The plain reference of portbench: the yardstick that decides `correct`.

Frozen copies of the port's host modules (`params.py`, `numtheory.py`,
`encoder.py`), the reference engine on torch int64 tensors (`ckks.py`) and
the traffic's requests computed plainly (`workloads.py`). Nothing here
imports the measured program, `jax` or the JAX package.
"""
