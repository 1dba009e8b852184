"""Jacobian spectrum tooling.

Capability parity with the reference's solvers/eigenvalue_util.py
(gen_matrix + scripts/eigenvalue.py): assemble the dense Jacobian of a
matrix-free operator column by column and compute/save its spectrum — used
to study integrator stability regions for a given RHS.

JAX twist: the columns come from one jitted jvp program evaluated
at the basis vectors (vmapped in chunks), not finite differences.
"""

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np


def gen_matrix(matvec: Callable, n: int, chunk: int = 64) -> np.ndarray:
    """Dense matrix of a matrix-free operator (column-by-column probing)."""
    cols = []
    for start in range(0, n, chunk):
        size = min(chunk, n - start)
        block = np.zeros((size, n))
        for i in range(size):
            e = np.zeros(n)
            e[start + i] = 1.0
            block[i] = np.asarray(matvec(e)).ravel()
        cols.append(block.T)
    return np.concatenate(cols, axis=1)


def jacobian_matrix(rhs: Callable, q, chunk: int = 64) -> np.ndarray:
    """Dense Jacobian of a jittable RHS at state q via vmapped jvp."""
    q = jnp.asarray(q)
    n = q.size

    @jax.jit
    def jvp_batch(vs):
        return jax.vmap(lambda v: jax.jvp(rhs, (q,), (v.reshape(q.shape),))[1].ravel())(vs)

    cols = []
    for start in range(0, n, chunk):
        size = min(chunk, n - start)
        basis = np.zeros((size, n))
        basis[np.arange(size), start + np.arange(size)] = 1.0
        cols.append(np.asarray(jvp_batch(jnp.asarray(basis))).T)
    return np.concatenate(cols, axis=1)


def save_spectrum(matrix: np.ndarray, path: str, compute_vectors: bool = False) -> np.ndarray:
    """Eigenvalues (optionally vectors) of the assembled Jacobian, saved as
    .npz; returns the eigenvalues."""
    if compute_vectors:
        vals, vecs = np.linalg.eig(matrix)
        np.savez(path, eigenvalues=vals, eigenvectors=vecs)
    else:
        vals = np.linalg.eigvals(matrix)
        np.savez(path, eigenvalues=vals)
    return vals
