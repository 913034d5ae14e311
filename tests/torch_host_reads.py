"""A CPU detector of what a CUDA graph cannot capture: host reads and
outputs whose size depends on the data.

``NoHostReads`` is a ``TorchDispatchMode`` that raises ``HostReadError`` on
the ATen ops that read a tensor back to the host or size their output by its
values:

* ``_local_scalar_dense`` (``.item()``, ``int(t)``, ``float(t)``,
  ``bool(t)``), ``is_nonzero``, ``equal``, ``_linalg_check_errors`` (the
  info check of ``cholesky`` / ``inv`` / ``solve``);
* ``nonzero``, ``argwhere``, ``masked_select``, the ``unique`` family,
  ``bincount``, ``repeat_interleave`` without ``output_size``;
* ``index`` / ``index_put`` with a boolean index (a mask index is a
  ``nonzero``);
* ``lift_fresh`` (``torch.tensor`` of host data: a copy from the host on
  the card).

On the card ``torch.cuda.set_sync_debug_mode("error")`` sees the
synchronising ones at run time; this mode sees them on the CPU, before a
capture is tried.  It cannot see ``.numpy()`` of a CPU tensor, which reads
memory without an ATen op.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

REFUSED = {
    aten._local_scalar_dense: "reads a tensor element on the host",
    aten.is_nonzero: "reads a tensor's truth value on the host",
    aten.equal: "compares two tensors on the host",
    aten._linalg_check_errors: "checks a factorization's info on the host",
    aten.nonzero: "sizes its output by the data",
    aten.argwhere: "sizes its output by the data",
    aten.masked_select: "sizes its output by the data",
    aten._unique: "sizes its output by the data",
    aten._unique2: "sizes its output by the data",
    aten.unique_dim: "sizes its output by the data",
    aten.unique_consecutive: "sizes its output by the data",
    aten.bincount: "sizes its output by the data",
    aten.lift_fresh: "builds a tensor from host data",
}
_MASK_INDEXED = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_}


class HostReadError(RuntimeError):
    pass


def _bool_index(indices) -> bool:
    return any(t is not None and t.dtype in (torch.bool, torch.uint8) for t in indices)


class NoHostReads(TorchDispatchMode):
    """Raise on every op in ``REFUSED``, a boolean-mask index and a
    ``repeat_interleave`` with tensor repeats and no ``output_size``;
    ``ops`` counts the ops that ran."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        why = REFUSED.get(packet)
        if why is None and packet in _MASK_INDEXED and _bool_index(args[1]):
            why = "indexes with a boolean mask (a nonzero)"
        if (why is None and func in (aten.repeat_interleave.Tensor, aten.repeat_interleave.self_Tensor)
                and kwargs.get("output_size") is None):
            why = "sizes its output by the data"
        if why is not None:
            raise HostReadError(f"{func}: {why}")
        self.ops += 1
        return func(*args, **kwargs)
