"""The least work of portbench's requests: the algorithm's operations and
bytes at the request's shapes, whatever implements them.

`request_roofline` divides a request's least time (`Work.least_s`) by the
device's busy time per request. So every count here is a lower bound: an
implementation may do more work, never less, and the share cannot pass
100%. What is counted:

  NTT / INTT      N/2 log2 N lazy Harvey butterflies a row (no 4-step mid
                  twiddle, which a one-pass transform does without)
  ModUp           per digit: the digit's Shoup product by [(Q_d/q_i)^-1],
                  the centring count, the conversion to the rows outside
                  the digit, their NTT (the digit's own rows are not
                  transformed again)
  inner product   both key components over every digit and ext row
  ModDown         per component: INTT of the specials, their Shoup
                  product, the conversion, the NTT, a subtract and a
                  product by P^-1; in hmult merged with the rescale, as
                  one conversion to level-1 rows and one NTT of them
                  (the last limb's INTT beside the specials')
  elementwise     tensor product, plaintext products, adds

Operations per primitive, each its least form (the lazy forms of
`homulator_tpu_torch/benchlib.py`'s OPS at commit 7ddbfaf4d401): a lazy
Harvey butterfly 9 int32 operations (a lazy Shoup product 4, a
conditional subtract 2, three adds or subtracts), a lazy modular product
4, a lazy add or subtract 1.
Conversion and inner-product multiply-adds go to the tensor cores, as
kernel B3 runs them, at two operations each: one u8 multiply-add, fewer
than any product of 30-bit residues takes there. Bytes: every input,
plaintext and key slice the request uses read once, every output written
once; tables, twiddles and intermediates are not counted.

The peaks are `peaks.py`'s. Words are 4 bytes (30-bit residues).
"""

from __future__ import annotations

import dataclasses

from . import peaks

BUTTERFLY = 9
PRODUCT = 4
ADD = 1
MAC = 2
WORD = 4


@dataclasses.dataclass(frozen=True)
class Work:
    int32_ops: float = 0.0
    tc_ops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.int32_ops + o.int32_ops, self.tc_ops + o.tc_ops,
                    self.bytes + o.bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.int32_ops * k, self.tc_ops * k, self.bytes * k)

    __rmul__ = __mul__

    def times(self) -> dict:
        """Seconds at each peak: bytes, int32 operations, tensor cores."""
        return {"bytes": self.bytes / peaks.HBM_BYTES_PER_S,
                "int32": self.int32_ops / peaks.INT32_OPS_PER_S,
                "tensor_cores": self.tc_ops / peaks.INT8_TC_OPS_PER_S}

    def least_s(self) -> float:
        return max(self.times().values())

    def bound_by(self) -> str:
        t = self.times()
        return max(t, key=t.get)


def elementwise(n: int, rows: int, products: int = 0,
                adds: int = 0) -> Work:
    return Work(int32_ops=rows * n * (products * PRODUCT + adds * ADD))


def ntt(n: int, rows: int) -> Work:
    """One forward or inverse transform of `rows` rows."""
    return Work(int32_ops=rows * (n // 2) * (n.bit_length() - 1) * BUTTERFLY)


def conversion(n: int, rows_in: int, rows_out: int) -> Work:
    """A centred base conversion of rows_in rows (plus the count row) to
    rows_out rows: rows_out x (rows_in + 1) multiply-adds a coefficient."""
    return Work(tc_ops=rows_out * (rows_in + 1) * n * MAC)


def digits(level: int, alpha: int):
    return [(lo, min(lo + alpha, level)) for lo in range(0, level, alpha)]


def modup(n: int, level: int, alpha: int) -> Work:
    """INTT of the operand, then per digit the lift to the ext basis."""
    w = ntt(n, level)
    for lo, hi in digits(level, alpha):
        nd = hi - lo
        other = level + alpha - nd
        w = (w + elementwise(n, nd, products=1, adds=1)
             + conversion(n, nd, other) + ntt(n, other))
    return w


def inner_product(n: int, level: int, alpha: int) -> Work:
    beta = len(digits(level, alpha))
    return Work(tc_ops=2 * beta * (level + alpha) * n * MAC)


def moddown(n: int, level: int, alpha: int) -> Work:
    """One component's ModDown to `level` rows."""
    return (ntt(n, alpha) + elementwise(n, alpha, products=1, adds=1)
            + conversion(n, alpha, level) + ntt(n, level)
            + elementwise(n, level, products=1, adds=1))


def moddown_rescale(n: int, level: int, alpha: int) -> Work:
    """One component's relinearisation add, ModDown and rescale, merged:
    the specials' and the last limb's INTT, one conversion to level-1
    rows, their NTT, a subtract and a product by (P q_last)^-1."""
    return (elementwise(n, level, adds=1) + ntt(n, alpha + 1)
            + elementwise(n, alpha, products=1, adds=1)
            + conversion(n, alpha + 1, level - 1) + ntt(n, level - 1)
            + elementwise(n, level - 1, products=1, adds=1))


def key_bytes(n: int, level: int, alpha: int) -> float:
    """One key-switch key's slice at `level`: every digit, both
    components, the ext rows."""
    return len(digits(level, alpha)) * 2 * (level + alpha) * n * WORD


def ct_bytes(n: int, level: int) -> float:
    return 2 * level * n * WORD


def hmult(n: int, level: int, alpha: int) -> Work:
    """One hmult's operations: tensor product, key switch of d2, merged
    relinearisation add, ModDown and rescale of both components."""
    return (elementwise(n, level, products=4, adds=1)
            + modup(n, level, alpha) + inner_product(n, level, alpha)
            + 2 * moddown_rescale(n, level, alpha))


def hmult_batch(n: int, level: int, alpha: int, batch: int) -> Work:
    """A batch of hmults by one relinearisation key, read once."""
    io = 2 * ct_bytes(n, level) + ct_bytes(n, level - 1)
    return (batch * (hmult(n, level, alpha) + Work(bytes=io))
            + Work(bytes=key_bytes(n, level, alpha)))


def matvec_bsgs(n: int, level: int, alpha: int, d: int, g: int) -> Work:
    """A d x d BSGS matvec at `level`: the g-1 baby rotations share one
    ModUp (bit-identical to one each), each pays its inner product and
    two ModDowns; d/g-1 giant rotations each a whole key switch; d
    plaintext products, the group and giant sums; no rescale."""
    giants = d // g - 1
    rot_tail = (inner_product(n, level, alpha)
                + 2 * moddown(n, level, alpha)
                + elementwise(n, level, adds=1))
    ops = (modup(n, level, alpha) + (g - 1) * rot_tail
           + giants * (modup(n, level, alpha) + rot_tail)
           + elementwise(n, 2 * level, products=d, adds=d - 1))
    io = (2 * ct_bytes(n, level) + d * level * n * WORD
          + (g - 1 + giants) * key_bytes(n, level, alpha))
    return ops + Work(bytes=io)
