"""Shape, layout, product, indexing, ordering and creation ops.

Counterpart of ``mxnet_tpu/ops/matrix.py:24-485``: ``Reshape`` (MXNet's
codes: 0 copy, -1 infer, -2 copy the rest, -3 merge two, -4 split one,
and ``reverse``), ``Flatten``, ``expand_dims``, ``transpose``,
``SwapAxis``, ``reshape_like``, ``Concat``, ``stack``,
``SliceChannel``/``split``, ``slice``/``crop``, ``slice_axis``,
``slice_like``, ``reverse``/``flip``, ``tile``, ``repeat``,
``Pad``/``pad``; ``dot`` and ``batch_dot`` (``torch.tensordot`` and
``torch.matmul``: the JAX package leaves them to XLA's ``dot_general``,
outside any kernel; ``dot`` of a CSR left operand goes to
``sparse_dot.dot``, the ``csr_dot`` kernels); the storage ops
``cast_storage`` (the dense values, which ``ndarray.sparse.cast_storage``
tags) and ``sparse_retain`` (the rows named, the others zero); ``take``, ``batch_take``, ``pick``, ``Embedding``,
``one_hot``, ``gather_nd``, ``scatter_nd``, ``_scatter_set_nd``;
``sort``, ``argsort``, ``topk``; the creation ops ``_zeros``,
``_ones``, ``_full``, ``_arange``, ``_eye``, ``zeros_like``,
``ones_like``, ``diag``; and ``_slice_assign``/``_crop_assign``,
``_crop_assign_scalar``, ``_NoGradient``, ``_CrossDeviceCopy``,
``IdentityAttachKLSparseReg`` and ``_internal_getitem``; and the ten
``_linalg_*`` ops with their ``linalg_*`` aliases (``:208-250``:
``gemm``, ``gemm2``, ``potrf``, ``potri``, ``trsm``, ``trmm``,
``sumlogdiag``, ``syrk``, ``syevd``, ``gelqf``) in ``torch.linalg``.

Tie order is the JAX package's: ``sort``/``argsort`` are stable
ascending, and a descending one is the flip of the ascending one;
``topk`` takes ``lax.top_k``'s order (largest first, the lower index
first among equals) from a stable descending sort.  ``argsort`` and
``topk`` return indices in their ``dtype`` attr (float32 by default).
Indices are clipped into range where a gather would otherwise read out
of bounds (``take`` clip/wrap, ``batch_take``, ``Embedding``): an index
the JAX package would fill with NaN is clipped here.  ``Embedding``'s
gradient is a row scatter-add (``index_select``'s backward is
``index_add_``), so duplicate indices add up.  ``_arange`` builds on
the op's device by ``numpy.arange``'s length and fill rules, which
``jnp.arange`` follows where a step is given.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import torch_dtype
from . import sparse_dot
from .elemwise import _block_grad_bwd
from .registry import op_device as _op_device, register


def _reshape_target(src, shape):
    out, src_i, infer_idx, i = [], 0, None, 0
    while i < len(shape):
        s = shape[i]
        if s > 0:
            out.append(s)
            src_i += 1
        elif s == 0:  # copy dim
            out.append(src[src_i])
            src_i += 1
        elif s == -1:  # infer
            infer_idx = len(out)
            out.append(1)
            src_i += 1
        elif s == -2:  # copy all remaining
            out.extend(src[src_i:])
            src_i = len(src)
        elif s == -3:  # merge two dims
            out.append(src[src_i] * src[src_i + 1])
            src_i += 2
        elif s == -4:  # split dim into next two shape values
            a, b = shape[i + 1], shape[i + 2]
            d = src[src_i]
            if a == -1:
                a = d // b
            if b == -1:
                b = d // a
            out.extend([a, b])
            src_i += 1
            i += 2
        i += 1
    if infer_idx is not None:
        known = math.prod(d for j, d in enumerate(out) if j != infer_idx)
        out[infer_idx] = math.prod(src) // max(known, 1)
    return out


@register("Reshape", aliases=["reshape"])
def _reshape(x, shape=None, reverse=False, target_shape=None, **kw):
    if shape is None and target_shape is not None:  # legacy attr
        return x.reshape(tuple(target_shape))
    src, shape = list(x.shape), tuple(shape)
    if reverse:
        out = _reshape_target(src[::-1], shape[::-1])[::-1]
    else:
        out = _reshape_target(src, shape)
    return x.reshape(tuple(out))


@register("Flatten", aliases=["flatten"])
def _flatten(x, **kw):
    return x.reshape((x.shape[0], -1))


@register("Concat", aliases=["concat"])
def _concat(*args, dim=1, num_args=None, **kw):
    return torch.cat(args, dim=dim)


@register("SwapAxis", aliases=["swapaxes"])
def _swapaxes(x, dim1=0, dim2=0, **kw):
    return torch.swapaxes(x, dim1, dim2)


@register("reshape_like", nondiff_inputs=(1,))
def _reshape_like(x, like, **kw):
    return x.reshape(like.shape)


@register("slice_axis")
def _slice_axis(x, axis=0, begin=0, end=None, **kw):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


@register("pick", nondiff_inputs=(1,))
def _pick(x, index, axis=-1, keepdims=False, mode="clip", **kw):
    """``x``'s entries at ``index`` along ``axis``; an index outside the
    axis is clipped into it (MXNet's ``mode="clip"``)."""
    ax = axis % x.ndim
    idx = index.to(torch.int64).clamp(0, x.shape[ax] - 1).unsqueeze(ax)
    out = torch.gather(x, ax, idx)
    return out if keepdims else out.squeeze(ax)


@register("expand_dims")
def _expand_dims(x, axis=0, **kw):
    return torch.unsqueeze(x, axis)


@register("transpose")
def _transpose(x, axes=None, **kw):
    if axes is None or axes == ():
        axes = tuple(reversed(range(x.ndim)))
    return x.permute(tuple(axes))


@register("stack")
def _stack(*args, axis=0, num_args=None, **kw):
    return torch.stack(args, dim=axis)


def _split_outputs(attrs):
    return int(attrs.get("num_outputs", 1))


@register("SliceChannel", aliases=["split"], num_outputs=_split_outputs)
def _split(x, num_outputs=1, axis=1, squeeze_axis=False, **kw):
    n = int(num_outputs)
    if x.shape[axis] % n:
        raise ValueError("split: axis %d of size %d does not divide into %d"
                         % (axis, x.shape[axis], n))
    parts = torch.split(x, x.shape[axis] // n, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("_internal_getitem")
def _internal_getitem(x, key=None, **kw):
    """``x[key]`` as a registered op (the key travels as a live attr)."""
    return x[key]


def _forward_slices(shape, slices):
    """Basic slices with steps > 0 for ``slices`` (each a ``slice``),
    and the axes to flip after taking them: a negative step takes the
    same elements in reverse order."""
    out, flips = [], []
    for i, sl in enumerate(slices):
        if sl.step is None or sl.step > 0:
            out.append(sl)
            continue
        idx = range(*sl.indices(shape[i]))
        if len(idx) == 0:
            out.append(slice(0, 0))
        else:
            out.append(slice(idx[-1], idx[0] + 1, -sl.step))
            flips.append(i)
    return tuple(out), flips


def _region(shape, begin, end, step=None):
    """Slices for MXNet's begin/end(/step) attrs (None: the whole axis)."""
    begin, end = tuple(begin), tuple(end)
    step = tuple(step) if step else (None,) * len(begin)
    out = []
    for i in range(len(shape)):
        b = begin[i] if i < len(begin) else None
        e = end[i] if i < len(end) else None
        st = step[i] if i < len(step) else None
        out.append(slice(b, e, st if st not in (0,) else None))
    return out


def _take_region(x, slices):
    fwd, flips = _forward_slices(x.shape, slices)
    out = x[fwd]
    return torch.flip(out, flips) if flips else out


@register("slice", aliases=["crop"])
def _slice(x, begin=(), end=(), step=None, **kw):
    step = step or (None,) * len(begin)
    return _take_region(x, [slice(b, e, s) for b, e, s in
                            zip(begin, end, step)])


@register("slice_like", nondiff_inputs=(1,))
def _slice_like(x, like, axes=(), **kw):
    shape = list(x.shape)
    for a in axes or range(x.ndim):
        shape[a] = like.shape[a]
    return x[tuple(slice(0, s) for s in shape)]


@register("reverse", aliases=["flip"])
def _reverse(x, axis=(), **kw):
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(x, ax)


@register("tile")
def _tile(x, reps=(), **kw):
    return torch.tile(x, tuple(reps))


@register("repeat")
def _repeat(x, repeats=1, axis=None, **kw):
    return torch.repeat_interleave(x, int(repeats), dim=axis)


def _pad_index(n, lo, hi, mode, device):
    """Indices into an axis of size ``n`` that ``np.pad`` reads for a pad
    of (lo, hi): ``edge`` repeats the end, ``reflect`` mirrors about it."""
    i = np.arange(-lo, n + hi)
    if mode == "edge":
        i = np.clip(i, 0, n - 1)
    else:
        period = 2 * (n - 1) if n > 1 else 1
        i = np.abs(i) % period
        i = np.where(i >= n, period - i, i)
    return torch.as_tensor(i, device=device)


@register("Pad", aliases=["pad"])
def _pad(x, mode="constant", pad_width=(), constant_value=0.0, **kw):
    pw = [(pad_width[2 * i], pad_width[2 * i + 1])
          for i in range(len(pad_width) // 2)]
    if mode == "constant":
        flat = [w for lo, hi in reversed(pw) for w in (lo, hi)]
        return F.pad(x, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError("unknown pad mode %s" % mode)
    for axis, (lo, hi) in enumerate(pw):
        if lo or hi:
            x = torch.index_select(x, axis, _pad_index(
                x.shape[axis], lo, hi, mode, x.device))
    return x


@register("dot", aliases=["_sparse_dot"], csr_inputs=(0,))
def _dot(a, b, transpose_a=False, transpose_b=False, forward_stype=None,
         **kw):
    if isinstance(a, sparse_dot.CSR):
        return sparse_dot.dot(a, b, transpose_a, transpose_b)
    if transpose_a and a.ndim > 1:
        a = torch.swapaxes(a, -1, -2)
    if transpose_b and b.ndim > 1:
        b = torch.swapaxes(b, -1, -2)
    # MXNet's dot of n-d arrays contracts a's last axis with b's first
    return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))


@register("batch_dot")
def _batch_dot(a, b, transpose_a=False, transpose_b=False, **kw):
    if transpose_a:
        a = torch.swapaxes(a, -1, -2)
    if transpose_b:
        b = torch.swapaxes(b, -1, -2)
    return torch.matmul(a, b)


@register("cast_storage", aliases=["_sparse_cast_storage"])
def _cast_storage(x, stype=None, **kw):
    return x


@register("sparse_retain", aliases=["_sparse_retain"], nondiff_inputs=(1,))
def _sparse_retain(data, indices, **kw):
    keep = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    keep[indices.to(torch.int64)] = True
    return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)), data,
                       torch.zeros((), dtype=data.dtype, device=data.device))


def _index(indices):
    """An index tensor as int64, truncated toward zero as ``astype``."""
    return indices.to(torch.int64)


def _take_rows(a, idx, axis):
    """``jnp.take`` of in-range ``idx`` along ``axis``."""
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("take", nondiff_inputs=(1,))
def _take(a, indices, axis=0, mode="clip", **kw):
    axis = axis % a.ndim
    n = a.shape[axis]
    idx = _index(indices)
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    return _take_rows(a, idx, axis)


@register("batch_take", nondiff_inputs=(1,))
def _batch_take(a, indices, **kw):
    idx = _index(indices)
    n = a.shape[1]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return torch.gather(a, 1, idx[:, None])[:, 0]


@register("Embedding", nondiff_inputs=(0,))
def _embedding(data, weight, input_dim=None, output_dim=None,
               dtype="float32", sparse_grad=False, **kw):
    n = weight.shape[0]
    idx = _index(data)
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return _take_rows(weight, idx, 0)


@register("one_hot")
def _one_hot(indices, depth=1, on_value=1.0, off_value=0.0,
             dtype="float32", **kw):
    depth = int(depth)
    oh = (_index(indices).unsqueeze(-1) == torch.arange(
        depth, device=indices.device)).to(torch_dtype(dtype))
    return oh * on_value + (1 - oh) * off_value


def _nd_index(indices):
    return tuple(_index(indices[i]) for i in range(indices.shape[0]))


@register("gather_nd", nondiff_inputs=(1,))
def _gather_nd(data, indices, **kw):
    return data[_nd_index(indices)]


@register("scatter_nd", nondiff_inputs=(1,))
def _scatter_nd(data, indices, shape=(), **kw):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_nd_index(indices), data)


@register("_scatter_set_nd", nondiff_inputs=(1,))
def _scatter_set_nd(lhs, indices, rhs, shape=(), **kw):
    return lhs.index_put(_nd_index(indices), rhs)


def _sorted(x, axis, descending=False):
    """A stable sort along ``axis`` (None: the flattened array), values
    and indices."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.sort(x, dim=axis, descending=descending, stable=True)


@register("sort")
def _sort(x, axis=-1, is_ascend=True, **kw):
    out = _sorted(x, axis).values
    if not is_ascend:
        out = torch.flip(out, (0 if axis is None else axis,))
    return out


@register("argsort")
def _argsort(x, axis=-1, is_ascend=True, dtype="float32", **kw):
    out = _sorted(x, axis).indices
    if not is_ascend:
        out = torch.flip(out, (0 if axis is None else axis,))
    return out.to(torch_dtype(dtype))


def _topk_nout(attrs):
    return 2 if attrs.get("ret_typ", "indices") == "both" else 1


@register("topk", num_outputs=_topk_nout)
def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32", **kw):
    axis = x.ndim - 1 if axis is None else axis % x.ndim
    xs = torch.movedim(x, axis, -1)
    # lax.top_k: the k largest (of -x: smallest), the lower index first
    # among equals, which a stable sort gives
    vals, idx = torch.sort(xs, dim=-1, descending=not is_ascend, stable=True)
    vals, idx = vals[..., :int(k)], idx[..., :int(k)]
    if ret_typ == "mask":
        mask = torch.zeros_like(xs).scatter(-1, idx, 1.0)
        return torch.movedim(mask, -1, axis)
    vals = torch.movedim(vals, -1, axis)
    idx = torch.movedim(idx, -1, axis).to(torch_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx
    return vals, idx


def _shape_of(shape):
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(shape)


@register("_zeros", aliases=["zeros_like_dummy"], no_inputs=True)
def _zeros(shape=(), dtype="float32", ctx=None, **kw):
    return torch.zeros(_shape_of(shape), dtype=torch_dtype(dtype),
                       device=_op_device(ctx))


@register("_ones", no_inputs=True)
def _ones(shape=(), dtype="float32", ctx=None, **kw):
    return torch.ones(_shape_of(shape), dtype=torch_dtype(dtype),
                      device=_op_device(ctx))


@register("_full", no_inputs=True)
def _full(shape=(), dtype="float32", value=0.0, ctx=None, **kw):
    return torch.full(_shape_of(shape), value, dtype=torch_dtype(dtype),
                      device=_op_device(ctx))


@register("_arange", no_inputs=True)
def _arange(start=0, stop=None, step=1.0, repeat=1, dtype="float32",
            ctx=None, infer_range=False, **kw):
    if stop is None:
        start, stop = 0, start
    dt = torch_dtype(dtype)
    dev = _op_device(ctx)
    n = max(0, math.ceil((stop - start) / step))
    # numpy's fill rule: the first two values in the dtype, then
    # first + i * (second - first), in float32 for the 16-bit types
    fill = torch.float32 if dt in (torch.float16, torch.bfloat16) else dt
    first = torch.tensor(start, dtype=dt, device=dev).to(fill)
    second = torch.tensor(start + step, dtype=dt, device=dev).to(fill)
    out = torch.arange(n, dtype=fill, device=dev) * (second - first) + first
    if n > 1:
        out[1] = second
    out = out.to(dt)
    if repeat > 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register("_eye", no_inputs=True)
def _eye(N=0, M=0, k=0, dtype="float32", ctx=None, **kw):
    n = int(N)
    m = int(M) if M else n
    dev = _op_device(ctx)
    rows = torch.arange(n, device=dev)[:, None] + int(k)
    return (rows == torch.arange(m, device=dev)[None, :]).to(
        torch_dtype(dtype))


@register("zeros_like")
def _zeros_like(x, **kw):
    return torch.zeros_like(x)


@register("ones_like")
def _ones_like(x, **kw):
    return torch.ones_like(x)


@register("diag")
def _diag(x, k=0, **kw):
    return torch.diag(x, int(k))


@register("_slice_assign", aliases=["_crop_assign"])
def _slice_assign(lhs, rhs, begin=(), end=(), step=(), **kw):
    """``lhs`` with ``rhs`` written into ``lhs[begin:end:step]`` (a new
    array: the reference's functional in-place)."""
    fwd, flips = _forward_slices(lhs.shape, _region(lhs.shape, begin, end,
                                                    step))
    out = lhs.clone()
    out[fwd] = torch.flip(rhs, flips) if flips else rhs
    return out


@register("_crop_assign_scalar")
def _crop_assign_scalar(data, scalar=0.0, begin=(), end=(), **kw):
    fwd, _ = _forward_slices(data.shape, _region(data.shape, begin, end))
    out = data.clone()
    out[fwd] = scalar
    return out


@register("_NoGradient", custom_vjp=_block_grad_bwd)
def _no_gradient(data, **kw):
    """Identity whose gradient is zero."""
    return data.clone()


@register("_CrossDeviceCopy")
def _cross_device_copy(data, **kw):
    """A device-boundary copy node; placement is the executor's, so the op
    is the identity."""
    return data


def _kl_sparse_bwd(out_grads, inputs, outputs, attrs):
    data = inputs[0]
    target = float(attrs.get("sparseness_target", 0.1))
    penalty = float(attrs.get("penalty", 0.001))
    # the mean activation of each unit over the batch
    rho_hat = torch.clamp(torch.mean(data, dim=0, keepdim=True), 1e-6,
                          1 - 1e-6)
    kl_grad = (-target / rho_hat + (1.0 - target) / (1.0 - rho_hat)) \
        / data.shape[0]
    return (out_grads[0] + penalty * kl_grad,)


@register("IdentityAttachKLSparseReg", custom_vjp=_kl_sparse_bwd)
def _identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                   penalty=0.001, momentum=0.9, **kw):
    """Identity forward; the backward adds the gradient of a KL penalty
    that drives the mean activations toward ``sparseness_target``."""
    return data.clone()


# --- linalg (MXNet's la_op; torch.linalg in place of LAPACK/XLA) -------------
def _t(x, flag):
    return x.transpose(-1, -2) if flag else x


@register("_linalg_gemm2", aliases=["linalg_gemm2"])
def _linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0,
                  axis=-2, **kw):
    return alpha * torch.matmul(_t(a, transpose_a), _t(b, transpose_b))


@register("_linalg_gemm", aliases=["linalg_gemm"])
def _linalg_gemm(a, b, c, transpose_a=False, transpose_b=False, alpha=1.0,
                 beta=1.0, **kw):
    return (alpha * torch.matmul(_t(a, transpose_a), _t(b, transpose_b))
            + beta * c)


@register("_linalg_potrf", aliases=["linalg_potrf"])
def _linalg_potrf(a, **kw):
    """The lower Cholesky factor."""
    return torch.linalg.cholesky(a)


@register("_linalg_potri", aliases=["linalg_potri"])
def _linalg_potri(a, **kw):
    """inv(L L^T) from the Cholesky factor L."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device) \
        .expand(a.shape)
    linv = torch.linalg.solve_triangular(a, eye, upper=False)
    return torch.matmul(linv.transpose(-1, -2), linv)


@register("_linalg_trsm", aliases=["linalg_trsm"])
def _linalg_trsm(a, b, transpose=False, rightside=False, alpha=1.0,
                 lower=True, **kw):
    """X with op(A) X = alpha B, or X op(A) = alpha B with ``rightside``;
    op(A) is A or, with ``transpose``, A^T; only A's ``lower`` (or upper)
    triangle is read."""
    a_op = _t(a, transpose)
    upper = lower if transpose else not lower
    return torch.linalg.solve_triangular(a_op, alpha * b, upper=upper,
                                         left=not rightside)


@register("_linalg_trmm", aliases=["linalg_trmm"])
def _linalg_trmm(a, b, transpose=False, rightside=False, alpha=1.0,
                 lower=True, **kw):
    """alpha op(A) B, or alpha B op(A) with ``rightside``; as in the JAX
    package the whole of A is used, whatever ``lower`` says."""
    at = _t(a, transpose)
    return alpha * (torch.matmul(b, at) if rightside else torch.matmul(at, b))


@register("_linalg_sumlogdiag", aliases=["linalg_sumlogdiag"])
def _linalg_sumlogdiag(a, **kw):
    return torch.log(torch.diagonal(a, dim1=-2, dim2=-1)).sum(dim=-1)


@register("_linalg_syrk", aliases=["linalg_syrk"])
def _linalg_syrk(a, transpose=False, alpha=1.0, **kw):
    return alpha * (torch.matmul(a.transpose(-1, -2), a) if transpose
                    else torch.matmul(a, a.transpose(-1, -2)))


@register("_linalg_syevd", aliases=["linalg_syevd"], num_outputs=2)
def _linalg_syevd(a, **kw):
    """(U, lambda) with A = U^T diag(lambda) U, the eigenvalues ascending;
    each row of U is unique only up to its sign."""
    w, v = torch.linalg.eigh(a)
    return v.transpose(-1, -2), w


@register("_linalg_gelqf", aliases=["linalg_gelqf"], num_outputs=2)
def _linalg_gelqf(a, **kw):
    """(L, Q) with A = L Q, L lower triangular and Q's rows orthonormal
    (the JAX package's output order); unique only up to the signs of Q's
    rows and L's columns."""
    q, r = torch.linalg.qr(a.transpose(-1, -2))
    return r.transpose(-1, -2), q.transpose(-1, -2)
