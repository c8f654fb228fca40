"""homulator_tpu_torch: the RNS-CKKS framework of `homulator_tpu` on
PyTorch and hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package stays the reference: this package shares its numpy-only
host modules (`homulator_tpu.params`, `numtheory`, `refimpl`, `encoder`,
`config`, `stats`) and reproduces its device results bit for bit, with the
same array layouts at every public function. It never imports JAX.

Slice implemented so far: `CkksEngine.hmult` / `hsquare` on the
accelerated single-device route (ModUp, digit inner product, fused
ModDown + rescale tail), carried by three CUDA kernels: the 4-step NTT,
its inverse, and the RNS base conversion (`csrc/`).
"""

__version__ = "0.1.0"
