"""homulator_tpu_torch: the RNS-CKKS framework of `homulator_tpu` on
PyTorch and hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package stays the reference: this package keeps its own copies of
the numpy-only host modules (`params`, `numtheory`, `refimpl`, `encoder`,
`config`, `stats`), reproduces the JAX package's device results bit for
bit with the same array layouts at every public function, and imports
nothing of `homulator_tpu` and no JAX.

Implemented so far: the single-device engine surface of the JAX
`CkksEngine` but `op_cost_counters` (`api.py`: hmult, hsquare, hrotate,
conjugate, hrotate_hoisted, keyswitch_poly, rescale, the elementwise ops,
plaintexts, the ntt / intt views) on the JAX package's three key-switch
routes (accelerated piecewise, fused HPIP with `api.USE_FUSED_HPIP`, and
the graph route with `ntt_mode="jnp"`), the CLI (`cli.py`), `serialize`,
`linalg`, and the coefficient-sharded hmult and hrotate (`parallel/`).
They are carried by the CUDA kernels of `csrc/`: the 4-step NTT and its
inverse, the two base conversions (fused and step 2), the fused ModUp NTT
+ key inner product, and the sharded NTT's phase kernels. On no op's
path, `csrc/` also holds the NTT anatomy kernels, the base conversion's
bf16-plane product on tensor cores and the roofline's peak chains, which
`benchlib.py` and the roofline and anatomy scripts time.
"""

__version__ = "0.2.0"
