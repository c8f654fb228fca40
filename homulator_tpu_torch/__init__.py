"""homulator_tpu_torch: the RNS-CKKS framework of `homulator_tpu` on
PyTorch and hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package stays the reference: this package keeps its own copies of
the numpy-only host modules (`params`, `numtheory`, `refimpl`, `encoder`,
`config`, `stats`), reproduces the JAX package's device results bit for
bit with the same array layouts at every public function, and imports
nothing of `homulator_tpu` and no JAX.

Slices implemented so far: `CkksEngine.hmult` / `hsquare` on the
accelerated single-device route (ModUp, digit inner product, fused
ModDown + rescale tail) and `hrotate` / `conjugate` / `hrotate_hoisted`,
each on the piecewise key-switch route or, with `api.USE_FUSED_HPIP`, the
fused HPIP route. They are carried by four CUDA kernels (`csrc/`): the
4-step NTT, its inverse, the RNS base conversion and the fused ModUp NTT +
key inner product.
"""

__version__ = "0.2.0"
