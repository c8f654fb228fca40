"""Key material and ciphertext serialization.

The port's copy of `homulator_tpu/serialize.py`: the same `.npz` format
and parameter fingerprint, so a key or ciphertext file written by either
package loads in the other, and a load into a context of other parameters
fails loudly. A ciphertext file holds the uint32 eval tiles
[2, level, n2, n1] of both packages' layout.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

FORMAT_VERSION = 1


def _fingerprint(params) -> str:
    return json.dumps({
        "v": FORMAT_VERSION,
        "n": params.n,
        "max_level": params.max_level,
        "alpha": params.alpha,
        "scale_bits": params.scale_bits,
        "q0": params.qs[0],
    })


def save_keys(path: str, ref) -> None:
    """Persist secret + relinearization + rotation keys of a RefCkks."""
    arrays: Dict[str, np.ndarray] = {
        "s_coeff": ref.s_coeff,
        "relin": np.stack(ref.relin_key.digits),
    }
    for step, key in getattr(ref, "rot_keys", {}).items():
        arrays[f"rot_{step}"] = np.stack(key.digits)
    np.savez_compressed(path, fingerprint=_fingerprint(ref.p), **arrays)


def load_keys(path: str, ref) -> None:
    """Restore keys into a RefCkks (verifies the parameter fingerprint).
    Recomputes the eval-domain secret from s_coeff, so the load is
    self-consistent with the context's NTT tables."""
    from .refimpl import KeySwitchKey

    with np.load(path, allow_pickle=False) as z:
        fp = str(z["fingerprint"])
        if fp != _fingerprint(ref.p):
            raise ValueError(f"key file context mismatch: {fp}")
        ref.s_coeff = z["s_coeff"]
        all_idx = np.arange(ref.p.num_primes)
        ref.s_eval = ref.ntt(ref.signed_to_rns(ref.s_coeff, all_idx), all_idx)
        ref.relin_key = KeySwitchKey(digits=list(z["relin"]))
        ref.rot_keys = {}
        for name in z.files:
            if name.startswith("rot_"):
                ref.rot_keys[int(name[4:])] = KeySwitchKey(
                    digits=list(z[name]))


def save_ciphertext(path: str, ct, params) -> None:
    """ct.data: the int32 tensor of a port Ciphertext (its bits are the
    uint32 residues the file holds)."""
    data = ct.data.detach().cpu().numpy().view(np.uint32)
    np.savez_compressed(
        path,
        fingerprint=_fingerprint(params),
        data=data,
        level=np.int64(ct.level),
        scale=np.float64(ct.scale),
        domain=np.bytes_(ct.domain.encode()),
    )


def load_ciphertext(path: str, dc):
    """The ciphertext of the file as a port Ciphertext on dc.device."""
    from .context import Ciphertext

    with np.load(path, allow_pickle=False) as z:
        if str(z["fingerprint"]) != _fingerprint(dc.params):
            raise ValueError("ciphertext context mismatch")
        data = np.ascontiguousarray(z["data"], dtype=np.uint32)
        return Ciphertext(
            torch.from_numpy(data.view(np.int32)).to(dc.device),
            int(z["level"]),
            float(z["scale"]),
            z["domain"].item().decode(),
        )
