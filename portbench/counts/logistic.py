"""The least work of the logistic-regression requests (`helr_iter`,
`logreg_sigmoid3`), built on `work.py`'s primitives and conventions: each
operation in its least form, every input, plaintext and key slice the
request uses read once, every output written once.

  rotation      the key switch of c1 (ModUp, inner product, both
                ModDowns) and the add into c0; with the a + rot(a) of a
                rotate-and-add, one more add of both components
  rescale       per component: the last limb's INTT, the NTT of its
                centred remainder into the level-1 rows, a subtract and a
                product by q_last^-1
  hsquare       hmult's count with three products in the tensor product
                (c0^2, c0 c1, c1^2) and the doubling add

A batch of B ciphertexts through one op reads its key once.
"""

from __future__ import annotations

from . import work
from .work import Work


def rotate_add(n: int, level: int, alpha: int, batch: int = 1) -> Work:
    """batch rotations by one key, each added to its input."""
    per = (work.modup(n, level, alpha) + work.inner_product(n, level, alpha)
           + 2 * work.moddown(n, level, alpha)
           + work.elementwise(n, level, adds=1)
           + work.elementwise(n, 2 * level, adds=1))
    return batch * per + Work(bytes=work.key_bytes(n, level, alpha))


def rescale(n: int, level: int) -> Work:
    """One component's rescale at `level`."""
    return (work.ntt(n, 1) + work.ntt(n, level - 1)
            + work.elementwise(n, level - 1, products=1, adds=1))


def hsquare(n: int, level: int, alpha: int) -> Work:
    return (work.elementwise(n, level, products=3, adds=1)
            + work.modup(n, level, alpha) + work.inner_product(n, level, alpha)
            + 2 * work.moddown_rescale(n, level, alpha))


def sigmoid3(n: int, level: int, alpha: int, batch: int = 1) -> Work:
    """c0 + c1 t + c3 t^3 of t at `level`: the squaring, t t^2, the two
    constant products, the add, the constant term."""
    lo = level - 2
    return batch * (hsquare(n, level, alpha) + work.hmult(n, level - 1, alpha)
                    + work.elementwise(n, 2 * lo, products=2, adds=1)
                    + work.elementwise(n, lo, adds=1))


def helr_iter(n: int, level: int, alpha: int, rows: int, features: int,
              blocks: int) -> Work:
    """One HELR iteration on `blocks` ciphertexts of rows x features
    samples from level L: Z v (-> L-1), log2(features) rotate-and-adds,
    the mask's product and rescale (-> L-2), as many replicating
    rotate-and-adds, the sigmoid (-> L-4), s Z (-> L-5), the blocks' sum,
    log2(rows) rotate-and-adds on the sum, the update's five constant
    products, three adds and the rescale of beta' and v' (-> L-6)."""
    L = level
    r, f, b = rows.bit_length() - 1, features.bit_length() - 1, blocks
    word = work.WORD
    ops = (b * work.hmult(n, L, alpha)
           + f * rotate_add(n, L - 1, alpha, b)
           + b * (work.elementwise(n, 2 * (L - 1), products=1)
                  + 2 * rescale(n, L - 1))
           + f * rotate_add(n, L - 2, alpha, b)
           + sigmoid3(n, L - 2, alpha, b)
           + b * work.hmult(n, L - 4, alpha)
           + (b - 1) * work.elementwise(n, 2 * (L - 5), adds=1)
           + r * rotate_add(n, L - 5, alpha)
           + work.elementwise(n, 2 * (L - 5), products=5, adds=3)
           + 4 * rescale(n, L - 5))
    io = (b * work.ct_bytes(n, L) + work.ct_bytes(n, L)
          + work.ct_bytes(n, L - 5)
          + ((L - 1) + (L - 4)) * n * word
          + work.key_bytes(n, L, alpha)
          + 2 * work.ct_bytes(n, L - 6))
    return ops + Work(bytes=io)


def logreg_sigmoid3(n: int, level: int, alpha: int) -> Work:
    """One ciphertext at `level`: the product by w, log2(slots)
    rotate-and-adds, + b, the rescale (-> L-1), the sigmoid (-> L-3)."""
    L = level
    steps = (n // 2).bit_length() - 1
    ops = (work.elementwise(n, 2 * L, products=1)
           + steps * rotate_add(n, L, alpha)
           + work.elementwise(n, L, adds=1) + 2 * rescale(n, L)
           + sigmoid3(n, L - 1, alpha))
    io = (work.ct_bytes(n, L) + 2 * L * n * work.WORD
          + work.key_bytes(n, L - 1, alpha) + (L - 3) * n * work.WORD
          + work.ct_bytes(n, L - 3))
    return ops + Work(bytes=io)
