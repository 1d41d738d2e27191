"""One rank's collectives, counted by kind as the JAX package's dry run
counts them in the optimized HLO (``src/repro/launch/dryrun.py``).

:class:`CollectiveCount` is a dispatch mode.  While it is active it sees
every collective the calling thread (a rank) hands to the dispatcher:
DTensor's redistributions and the port's functional collectives
(``torch.distributed._functional_collectives``).  It lets a DTensor op
through (``NotImplemented``), so that DTensor desugars it into the local
ops and collectives of the rank, which the mode then sees one by one.
The port's own calls of ``torch.distributed``'s collectives (the
vocab-parallel loss's ``all_reduce``, the MoE's rank offsets'
``all_gather``, the pipeline's ``all_to_all_single``) are seen by
wrappers of those functions, which count for the innermost counter on the
calling thread's dispatch-mode stack (the stack autograd carries into its
backward threads): the threaded process group of the one-card runs does
not hand those calls to the dispatcher.  The same counter runs in a measured run
(real tensors, one rank a process or a thread) and in the dry run (fake
tensors over a fake process group, ``launch.dryrun``), so the two agree
by construction where they run the same step.

The kinds are the reference's: ``all-gather``, ``all-reduce``,
``reduce-scatter``, ``all-to-all`` and ``collective-permute`` (a
point-to-point send), and ``broadcast``.  The bytes of a call are those
the rank hands it: an all-gather's shard, an all-reduce's or a
reduce-scatter's whole input, an all-to-all's send buffer, a send's
tensor.  A receive and the waits on an asynchronous collective are not
counted.
"""

from __future__ import annotations

import functools
from collections import Counter

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

__all__ = ["KINDS", "CollectiveCount", "collective_kind"]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
         "broadcast")

# the functional collectives (torch.ops._c10d_functional): op name -> kind;
# the tensor handed is the first argument
_FUNCOL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
# torch.distributed's collectives: name -> (kind, position and keyword of
# the tensor handed)
_DIST = {
    "all_reduce": ("all-reduce", 0, "tensor"),
    "all_gather": ("all-gather", 1, "tensor"),
    "all_gather_into_tensor": ("all-gather", 1, "input_tensor"),
    "reduce_scatter_tensor": ("reduce-scatter", 1, "input"),
    "all_to_all_single": ("all-to-all", 1, "input"),
    "broadcast": ("broadcast", 0, "tensor"),
    "send": ("collective-permute", 0, "tensor"),
}
_WRAPPED = []


def collective_kind(func) -> str | None:
    """The kind of a functional collective op, else None."""
    if getattr(func, "namespace", None) != "_c10d_functional":
        return None
    return _FUNCOL.get(func._opname)


def _active() -> "CollectiveCount | None":
    """The innermost counter on the calling thread's dispatch-mode stack."""
    return next((m for m in reversed(_get_current_dispatch_mode_stack())
                 if isinstance(m, CollectiveCount)), None)


def _wrap_dist() -> None:
    """Wrap ``torch.distributed``'s collectives (once per process) so that
    each call counts for the active counter (:func:`_active`)."""
    if _WRAPPED:
        return
    for name, (kind, pos, key) in _DIST.items():
        orig = getattr(dist, name)

        @functools.wraps(orig)
        def wrapped(*args, _orig=orig, _kind=kind, _pos=pos, _key=key, **kwargs):
            counter = _active()
            if counter is not None:
                counter.add(_kind, args[_pos] if len(args) > _pos else kwargs[_key])
            return _orig(*args, **kwargs)

        setattr(dist, name, wrapped)
        _WRAPPED.append(name)


class CollectiveCount(TorchDispatchMode):
    """Collective calls and bytes of the calling rank, by kind, while
    active (module docstring).  ``calls`` and ``bytes`` are
    ``Counter``\\ s by kind; :meth:`summary` gives ``{kind: {"calls",
    "bytes"}}``, :meth:`reference` the JAX package's dry-run dict."""

    def __init__(self):
        super().__init__()
        self.calls, self.bytes = Counter(), Counter()

    def add(self, kind: str, sent) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += sum(t.numel() * t.element_size() for t in tree_leaves(sent)
                                if isinstance(t, torch.Tensor))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # seen again as the rank's local ops
        kind = collective_kind(func)
        if kind is not None:
            self.add(kind, args[0])
        out = func(*args, **kwargs)
        if kind is None:
            self.local_op(func, args, kwargs, out)
        return out

    def __enter__(self):
        _wrap_dist()
        return super().__enter__()

    def local_op(self, func, args, kwargs, out) -> None:
        """Called after each local op that is not a collective (the dry run
        counts them); nothing here."""

    def summary(self) -> dict:
        return {k: {"calls": self.calls[k], "bytes": self.bytes[k]} for k in sorted(self.calls)}

    def reference(self) -> dict:
        """The reference's ``collective_bytes`` dict: bytes by kind, their
        ``total`` and the calls (``num_ops``)."""
        out = {k: float(self.bytes[k]) for k in sorted(self.calls)}
        out["total"] = float(sum(self.bytes.values()))
        out["num_ops"] = sum(self.calls.values())
        return out
