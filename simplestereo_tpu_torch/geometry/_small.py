"""Products and inverses of small matrices.

A ``@`` on the card may run in TF32 depending on global flags; the
products here take no such risk and add in the order of a row-by-column
product (k = 0, 1, 2, ...), as the JAX package's ``@`` does on the CPU.
A 3x3 inverse is host work: on the card it would be a solver launch and a
synchronisation for nine numbers.
"""

import numpy as np
import scipy.linalg
import torch


def matmul_small(A, B):
    """(n, k) @ (k, m) for small tensors, as sums of broadcast products."""
    out = A[:, 0:1] * B[0:1, :]
    for k in range(1, A.shape[1]):
        out = out + A[:, k:k + 1] * B[k:k + 1, :]
    return out


def apply_affine(M, comps):
    """Rows of ``[*comps, 1] @ M.T`` for a (r, n+1) matrix ``M`` and n
    component tensors: out_j = M[j,0]*c_0 + ... + M[j,n-1]*c_{n-1} + M[j,n].
    Returns a list of r tensors."""
    n = len(comps)
    out = []
    for j in range(M.shape[0]):
        acc = M[j, 0] * comps[0]
        for k in range(1, n):
            acc = acc + M[j, k] * comps[k]
        out.append(acc + M[j, n])
    return out


def inv_small(M):
    """Inverse of a small square tensor, computed on the host and returned
    on ``M``'s device in its dtype.

    LAPACK's LU factorisation and LU solve against the identity (``getrf``
    + ``getrs``, through scipy): the JAX package's ``jnp.linalg.inv`` does
    the same on the CPU, so the two agree bit for bit there.
    """
    m = M.detach().cpu().numpy()
    inv = scipy.linalg.lu_solve(scipy.linalg.lu_factor(m),
                                np.eye(m.shape[0], dtype=m.dtype))
    return torch.as_tensor(inv, device=M.device)
