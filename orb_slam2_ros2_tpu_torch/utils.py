"""Small shared helpers: bounded top-k and the scatter modes JAX has and torch
lacks.  Every helper here is free of host synchronisation, so the frame
program stays capturable."""

from __future__ import annotations

import torch


def topk_bounded(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis that tolerates ``k`` larger than it.

    Ties resolve to the lower index first, as ``lax.top_k`` does (a stable
    descending sort; ``torch.topk`` gives no such order).  Values pad with 0
    and indices with 0 when ``k`` exceeds the axis; callers gate on
    ``value > 0``.
    """
    n = x.shape[-1]
    kk = min(k, n)
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    v, i = v[..., :kk], i[..., :kk]
    if kk < k:
        pad = x.shape[:-1] + (k - kk,)
        v = torch.cat([v, torch.zeros(pad, dtype=v.dtype, device=v.device)], dim=-1)
        i = torch.cat([i, torch.zeros(pad, dtype=i.dtype, device=i.device)], dim=-1)
    return v, i


def last_of_duplicates(idx: torch.Tensor, n: int) -> torch.Tensor:
    """bool mask over ``idx [B]``: True at the last occurrence of each value
    (values outside ``[0, n)`` are all False).  Makes a scatter with
    repeated targets deterministic: keeping the last writer reproduces the
    sequential last-write-wins order of XLA:CPU, while ``index_put_`` with
    duplicates is unordered on CUDA (and on a parallel CPU loop)."""
    flat = idx.reshape(-1)
    ok = (flat >= 0) & (flat < n)
    tgt = torch.where(ok, flat, n).long()
    order = torch.arange(flat.shape[0], device=idx.device)
    last = torch.full((n + 1,), -1, dtype=torch.long, device=idx.device)
    last = last.scatter_reduce(0, tgt, order, reduce="amax")
    return (ok & (last[tgt] == order)).reshape(idx.shape)


def set_drop(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``x.at[idx].set(val, mode="drop")`` along dim 0, out of place.

    Writes through a buffer one row longer: out-of-range indices land in the
    scratch row, which is sliced away.  A Python scalar ``val`` is filled by
    the kernel (a scalar set-item would copy it from the host).  A tensor
    ``val`` with repeated indices keeps the last row's value on every device
    (``last_of_duplicates``).
    """
    n = x.shape[0]
    buf = torch.cat([x, x[:1]])
    if torch.is_tensor(val):
        idx = torch.where(last_of_duplicates(idx, n), idx, n).long()
        buf.index_put_((idx,), val.to(buf.dtype))
    else:
        ok = (idx >= 0) & (idx < n)
        buf.index_fill_(0, torch.where(ok, idx, n).long(), val)
    return buf[:n]


def set_drop_rows(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``set_drop`` along the last axis of every leading index at once:
    ``x [..., n]``, ``idx [..., q]`` and a tensor ``val [..., q]`` (or a
    Python scalar).  Out-of-range indices of a row are dropped, repeated
    ones keep that row's last writer."""
    *lead, n = x.shape
    rows = x.numel() // n
    off = torch.arange(rows, device=x.device).reshape(*lead, 1) * n
    flat = torch.where((idx >= 0) & (idx < n), idx.long() + off, rows * n).reshape(-1)
    val = val.reshape(-1) if torch.is_tensor(val) else val
    return set_drop(x.reshape(-1), flat, val).reshape(x.shape)


def add_drop_(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``x.at[idx].add(val, mode="drop")`` along dim 0, in place: out-of-range
    rows are clamped and add zero."""
    n = x.shape[0]
    ok = (idx >= 0) & (idx < n)
    val = torch.where(ok, val, 0).to(x.dtype)
    return x.index_add_(0, idx.clamp(0, n - 1).long(), val)


def count_into(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int32 histogram of ``idx`` over ``[0, n)``; other values are dropped
    (``zeros(n + 1).at[idx].add(1, mode="drop")[:n]``)."""
    idx = idx.reshape(-1)
    ok = (idx >= 0) & (idx < n)
    out = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
    out.index_add_(0, torch.where(ok, idx, n).long(), torch.ones_like(idx, dtype=torch.int32))
    return out[:n]


def mask_from_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """bool[n] with True at every id in ``ids`` inside ``[0, n)``."""
    return count_into(ids, n) > 0


def mask_from_ids_rows(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``mask_from_ids`` of every leading index at once: bool ``[..., n]``
    from ``ids [..., q]``."""
    ok = (ids >= 0) & (ids < n)
    out = torch.zeros((*ids.shape[:-1], n + 1), dtype=torch.bool, device=ids.device)
    return out.scatter(-1, torch.where(ok, ids, n).long(), True)[..., :n]
