"""Linear-algebra ops — the ``linalg_*`` family, ``khatri_rao`` and
``moments`` (counterpart of ``mxnet_tpu/ops/linalg.py`` and the linalg
names of ``mxnet_tpu/ops/tensor.py``).

The JAX package runs these with ``jnp.linalg``/``jax.scipy.linalg``
outside any Pallas kernel; the port runs them with ``torch.linalg``
(LAPACK on the host, cuSOLVER/cuBLAS on the card) and takes their
gradients from ``torch.autograd``.  Batch dimensions lead, the ops act
on the last two axes, and the JAX conventions hold: ``linalg_syevd``
returns the eigenvectors as the rows of U (A = Uᵀ diag(λ) U; solved in
float64, see there),
``linalg_gelqf`` is the QR of Aᵀ (A = L Q), and ``moments`` is a
two-pass mean and variance.  Eigenvectors and the LQ factors are fixed
up to a sign per vector, which LAPACK and cuSOLVER may choose apart.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register_op

__all__ = []


def _T(a):
    return a.transpose(-1, -2)


def _tri(a, lower):
    return torch.tril(a) if lower else torch.triu(a)


@register_op("linalg_gemm")
def _linalg_gemm(a, b, c, transpose_a=False, transpose_b=False, alpha=1.0,
                 beta=1.0, axis=-2):
    """alpha * op(A) @ op(B) + beta * C; ``axis`` is the matrix-row axis
    of N-d inputs (-2 by default; another axis is moved into place and
    back)."""
    move = axis not in (-2, a.dim() - 2)
    if move:
        a, b, c = (torch.movedim(t, axis, -2) for t in (a, b, c))
    if transpose_a:
        a = _T(a)
    if transpose_b:
        b = _T(b)
    out = alpha * torch.matmul(a, b) + beta * c
    return torch.movedim(out, -2, axis) if move else out


@register_op("linalg_gemm2")
def _linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0):
    """alpha * op(A) @ op(B)."""
    if transpose_a:
        a = _T(a)
    if transpose_b:
        b = _T(b)
    return alpha * torch.matmul(a, b)


@register_op("linalg_potrf")
def _linalg_potrf(a):
    """Lower Cholesky factor of a symmetric positive-definite matrix."""
    return torch.linalg.cholesky(a)


@register_op("linalg_potri")
def _linalg_potri(a):
    """The inverse of A = L Lᵀ from its Cholesky factor L:
    L⁻ᵀ L⁻¹."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(
        a.shape)
    linv = torch.linalg.solve_triangular(a, eye, upper=False)
    return torch.matmul(_T(linv), linv)


@register_op("linalg_trmm")
def _linalg_trmm(a, b, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    """alpha * op(tri(A)) @ B, or B @ op(tri(A)) when rightside."""
    tri = _tri(a, lower)
    if transpose:
        tri = _T(tri)
    out = torch.matmul(b, tri) if rightside else torch.matmul(tri, b)
    return alpha * out


@register_op("linalg_trsm")
def _linalg_trsm(a, b, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    """alpha * op(tri(A))⁻¹ B, or alpha * B op(tri(A))⁻¹ when
    rightside; only A's ``lower`` (or upper) triangle is read."""
    op_a, upper = (_T(a), lower) if transpose else (a, not lower)
    x = torch.linalg.solve_triangular(op_a, b, upper=upper,
                                      left=not rightside)
    return alpha * x


@register_op("linalg_syrk")
def _linalg_syrk(a, transpose=False, alpha=1.0):
    """alpha * A @ Aᵀ (Aᵀ @ A when transpose)."""
    at = _T(a)
    return alpha * (torch.matmul(at, a) if transpose
                    else torch.matmul(a, at))


@register_op("linalg_sumlogdiag")
def _linalg_sumlogdiag(a):
    """Sum of the log of each matrix's diagonal."""
    return torch.log(torch.diagonal(a, dim1=-2, dim2=-1)).sum(-1)


@register_op("linalg_extractdiag")
def _linalg_extractdiag(a, offset=0):
    """The ``offset``-th diagonal of each matrix as a vector."""
    return torch.diagonal(a, offset=offset, dim1=-2, dim2=-1)


@register_op("linalg_makediag")
def _linalg_makediag(a, offset=0):
    """A vector as the ``offset``-th diagonal of an otherwise zero
    square matrix."""
    return torch.diag_embed(a, offset=offset, dim1=-2, dim2=-1)


def _trian_indices(n, offset, lower, device):
    r, c = np.tril_indices(n, k=offset) if lower \
        else np.triu_indices(n, k=offset)
    return torch.from_numpy(r).to(device), torch.from_numpy(c).to(device)


def _trian_count(n, offset, lower):
    """The length of ``_trian_indices(n, offset, lower)``, in O(n)."""
    i = np.arange(n)
    if lower:
        return int(np.clip(i + offset + 1, 0, n).sum())
    return int(np.clip(n - np.maximum(i + offset, 0), 0, n).sum())


@register_op("linalg_extracttrian")
def _linalg_extracttrian(a, offset=0, lower=True):
    """The lower (or upper) triangle of each matrix packed row-major
    into a vector."""
    r, c = _trian_indices(a.shape[-1], offset, lower, a.device)
    return a[..., r, c]


@register_op("linalg_maketrian")
def _linalg_maketrian(a, offset=0, lower=True):
    """A packed triangle as an otherwise zero square matrix (n found
    from the packed length)."""
    k = a.shape[-1]
    n = 1
    while _trian_count(n, offset, lower) != k:
        n += 1
        if n > 4096:
            raise ValueError(f"cannot infer matrix size from {k} elements")
    r, c = _trian_indices(n, offset, lower, a.device)
    out = a.new_zeros(a.shape[:-1] + (n, n))
    out[..., r, c] = a
    return out


@register_op("linalg_syevd", num_outputs=2)
def _linalg_syevd(a):
    """Symmetric eigendecomposition A = Uᵀ diag(λ) U, eigenvectors as
    the rows of U, eigenvalues ascending.  Narrower floats are solved in
    float64 and rounded back: cuSOLVER's float32 ``eigh`` returned
    eigenvalues 2.3e-4 off (relative, 8 x 512², on an H100) where the
    float64 solve and LAPACK's float32 one are within 2e-7."""
    w, v = torch.linalg.eigh(a.double() if a.dtype != torch.float64 else a)
    return _T(v).to(a.dtype), w.to(a.dtype)


@register_op("linalg_gelqf", num_outputs=2)
def _linalg_gelqf(a):
    """LQ factorisation of a full-rank m x n matrix (m <= n), A = L Q
    with Q's rows orthonormal, through the QR of Aᵀ."""
    q, r = torch.linalg.qr(_T(a))
    return _T(r), _T(q)


@register_op("linalg_inverse", aliases=("inverse",))
def _linalg_inverse(a):
    return torch.linalg.inv(a)


@register_op("linalg_det", aliases=("det",))
def _linalg_det(a):
    return torch.linalg.det(a)


@register_op("linalg_slogdet", aliases=("slogdet",), num_outputs=2)
def _linalg_slogdet(a):
    """Sign and log|det| of each matrix."""
    sign, logdet = torch.linalg.slogdet(a)
    return sign, logdet


@register_op("linalg_solve", aliases=("solve",))
def _linalg_solve(a, b):
    """X with A X = B."""
    return torch.linalg.solve(a, b)


@register_op("khatri_rao")
def _khatri_rao(*xs):
    """Khatri-Rao product: the column-wise Kronecker product over the
    inputs' leading axes."""
    out = xs[0]
    for x in xs[1:]:
        out = torch.einsum("i...,j...->ij...", out, x).reshape(
            (-1,) + tuple(out.shape[1:]))
    return out


@register_op("moments", num_outputs=2)
def _moments(data, axes=None, keepdims=False):
    """Mean and variance over ``axes`` in two passes (the mean, then the
    mean squared deviation from it); half-precision data is reduced in
    float32 and returned in its own dtype, as ``jnp.mean``/``jnp.var``
    do."""
    dims = tuple(range(data.dim())) if axes is None else (
        (axes,) if isinstance(axes, int) else tuple(axes))
    x = data.float() if data.dtype in (torch.float16, torch.bfloat16) \
        else data
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=keepdims)
    if not keepdims:
        mean = mean.squeeze(dims) if dims else mean
    return mean.to(data.dtype), var.to(data.dtype)
