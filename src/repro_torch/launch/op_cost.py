"""Operation-level cost counter: the port's counterpart of ``hlo_cost.py`` and
``hlo_stats.py``.

The JAX package counts a compiled HLO module. The port compiles nothing:
every PyTorch op that runs is its own kernel. So ``OpCost`` is a
``TorchDispatchMode`` that counts the ops PyTorch dispatches, one by one,
as they run, on the card, on the CPU or on ``meta`` tensors (which carry
shapes only, so a step at full size costs no memory).

Conventions (``hlo_cost``'s where they carry over):

* flops: matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
  ``dot``, and what ``einsum``, ``matmul`` and ``linear`` decompose to)
  2 x prod(result) x prod(contracting), plus prod(result) for the added
  term; convolutions ``hlo_cost._conv_flops``' 2 x prod(result) x
  prod(kernel) / out_features, their backward once per gradient it makes;
  sorts n log2 n over the sorted dim; reductions one per input element;
  other elementwise ops one per output element; zero for views, copies,
  casts, gathers, scatters, concatenation, padding, fills and RNG.
* bytes: each op reads its tensor operands and writes its results, and
  that is its device traffic, because eager PyTorch fuses nothing. A view
  (an output that aliases an input: ``view``, ``expand``, ``t``,
  ``as_strided``, ``detach``, ...) launches nothing and costs 0. An
  in-place op charges what it reads plus what it writes. ``copy_`` reads
  its source and writes its destination, a fill writes only, ``empty``
  moves nothing. Gathers charge 2 x result, and an in-place scatter
  (``index_put_``, ``scatter_add_``, ...) 3 x update, as ``hlo_cost``
  charges (dynamic-)slices and XLA's in-place scatters. An out-of-place one
  (``index_put``, ``scatter_add``, ...) first copies ``self`` whole, so it
  also reads ``self`` and writes its result. A copy between
  devices moves no device-memory bytes: it is counted in
  ``transfer_bytes``.
* collectives: per ``c10d`` op (``allreduce_``, ``_allgather_base_``,
  ``_reduce_scatter_base_``, ``broadcast_``, ...), the group size from its
  ``ProcessGroup``, per-rank moved bytes by ``hlo_stats``' ring formulas:
  all-gather result x (n-1)/n, all-reduce 2 x bytes x (n-1)/n,
  reduce-scatter result x (n-1), all-to-all bytes x (n-1)/n, a send,
  receive or broadcast its bytes. A group of one moves nothing.
* peak live bytes: the storages the counted code creates (not views: an
  output that shares an input's storage is not new), added when made and
  taken off by a weak-reference finalizer when freed; the peak of their sum
  is the counterpart of ``memory_analysis().temp_size_in_bytes``.
* kernel regions (``kernels/cost.py`` ``region``): the port's hand kernels
  are C launchers the dispatcher does not see. Each direction of a kernel's
  autograd Function opens one region around its choice of device, the
  counter counts no op inside it, and the Function reports its kernel's
  own flops and bytes (the bounds' formulas), its outputs and any counts of
  its own (the input gather's transpose: the valid slots it summed against
  all T*K), under the kernel's name. On the CPU the region hides the plain
  version's ops, so a step counts the same on both devices.

The backward that autograd runs on its device threads is counted too: the
dispatch mode travels with autograd's thread-local state, as
``torch.utils.flop_counter`` relies on.
"""
from __future__ import annotations

import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import cost as _kcost

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute", "broadcast")

_MATMUL = {"mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot", "_addmm_activation"}
_CONV = {"convolution", "_convolution", "convolution_overrideable"}
_CONV_BWD = {"convolution_backward", "convolution_backward_overrideable"}
_SORT = {"sort", "argsort", "topk", "kthvalue", "msort"}
_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "norm", "linalg_vector_norm", "var", "std", "var_mean",
    "std_mean", "logsumexp", "cumsum", "cumprod", "cummax", "cummin", "all", "any", "argmax", "argmin",
    "_softmax", "_log_softmax", "nansum", "count_nonzero", "aminmax", "logcumsumexp", "native_layer_norm",
    "native_group_norm", "native_batch_norm", "_fused_rms_norm",
}
_GATHER = {"index", "index_select", "gather", "take", "embedding", "take_along_dim", "masked_select", "_unsafe_index"}
_SCATTER = {
    "index_put", "index_put_", "_index_put_impl_", "_index_put_impl", "index_add", "index_add_", "scatter",
    "scatter_", "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_", "index_copy", "index_copy_",
    "masked_scatter", "masked_scatter_", "index_fill", "index_fill_", "_unsafe_index_put",
}
_ZERO_FLOP = {
    "_to_copy", "copy", "copy_", "clone", "contiguous", "lift_fresh", "lift_fresh_copy", "cat", "stack",
    "constant_pad_nd", "pad", "flip", "roll", "repeat", "repeat_interleave", "slice_scatter", "select_scatter",
    "diagonal_scatter", "as_strided_scatter", "zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
    "new_zeros", "new_ones", "new_full", "new_empty", "new_empty_strided", "fill", "fill_", "zero_", "arange",
    "linspace", "eye", "scalar_tensor", "randn", "rand", "randint", "randn_like", "rand_like", "randint_like",
    "normal", "normal_", "uniform", "uniform_", "bernoulli", "bernoulli_", "randperm", "multinomial",
    "exponential_", "_local_scalar_dense", "nonzero", "unique", "_unique2", "unique_consecutive", "empty",
    "empty_like", "empty_strided", "empty_permuted", "resize_", "set_", "_embedding_bag", "alias", "tril_indices",
    "triu_indices", "split_with_sizes_copy", "unbind_copy", "view_copy", "detach_copy", "_foreach_copy_",
    "bucketize", "searchsorted", "one_hot", "_assert_async", "_assert_tensor_metadata", "sym_constrain_range",
    "record_stream", "_has_same_storage_numel", "resolve_conj", "resolve_neg", "_conj", "_neg_view",
    "select_backward", "slice_backward", "diagonal_backward", "as_strided_backward", "unfold_backward",
    "embedding_dense_backward", "tril", "triu",
}
_NO_BYTES = {"empty", "empty_like", "empty_strided", "empty_permuted", "new_empty", "new_empty_strided",
             "resize_", "set_", "_local_scalar_dense", "record_stream", "_assert_async", "_assert_tensor_metadata",
             "sym_constrain_range", "_has_same_storage_numel"}
_WRITE_ONLY = {"zeros", "ones", "full", "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
               "fill_", "zero_", "arange", "linspace", "eye", "scalar_tensor", "randn", "rand", "randint",
               "randn_like", "rand_like", "randint_like", "normal", "uniform", "randperm", "normal_", "uniform_",
               "bernoulli_", "exponential_"}
_COLL = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce", "all_reduce": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather", "all_gather_into_tensor": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all", "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute", "recv_any_source_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}
_TOP = 12


def _tensors(x) -> list:
    """The tensors in an op's argument or result (lists of them flattened)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):  # a tensor with no storage (a subclass, a sparse tensor)
        return None


def ring_moved_bytes(kind: str, nbytes: float, n: int) -> float:
    """Per-rank link bytes of one collective over ``n`` ranks (``hlo_stats``'
    ring formulas; ``nbytes`` is the gathered result of an all-gather, the
    scattered result of a reduce-scatter, else the tensor's bytes)."""
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return nbytes * (n - 1) / n
    if kind == "all-reduce":
        return 2 * nbytes * (n - 1) / n
    if kind == "reduce-scatter":
        return nbytes * (n - 1)
    if kind == "all-to-all":
        return nbytes * (n - 1) / n
    return float(nbytes)


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return int(torch._C._distributed_c10d.ProcessGroup.unbox(a).size())
        if isinstance(a, int) and not isinstance(a, bool):
            return a  # the functional collectives pass the group size as an int
    return 2  # unknown: the conservative default, as hlo_stats takes


class _Region:
    """One kernel's region in a counter: it hides the ops inside, and the
    wrapper ``report``s the kernel's own work and outputs."""

    def __init__(self, counter: "OpCost", name: str):
        self.counter, self.name = counter, name

    def __bool__(self) -> bool:
        return True

    def __enter__(self):
        self.counter._hidden += 1
        return self

    def __exit__(self, *exc) -> None:
        self.counter._hidden -= 1

    def report(self, flops: float, nbytes: float, *outputs, **tallies: int) -> None:
        """The kernel's work and outputs; ``tallies`` are counts of its own
        (e.g. the slots a transpose summed), added up in its ``by_op`` row."""
        c = self.counter
        c._add(self.name, float(flops), float(nbytes), None)
        row = c.by_op[self.name]
        for key, v in tallies.items():
            row[key] = row.get(key, 0) + v
        for t in _tensors(outputs):
            c._track(t, ())


class OpCost(TorchDispatchMode):
    """Count the flops, bytes, collectives and peak live bytes of the code
    run inside ``with OpCost() as c:``; ``c.result()`` afterwards."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transfer_bytes = 0.0
        self.coll = {k: {"count": 0.0, "moved_bytes": 0.0} for k in COLLECTIVES}
        self.by_op: dict[str, dict] = {}
        self._sites: dict[tuple, list] = {}
        self._coll_sites: dict[tuple, list] = {}
        self._hidden = 0
        self._live: dict = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0

    # ---------------------------------------------------------- context
    def __enter__(self):
        _kcost._counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _kcost._counters.remove(self)

    def region(self, name: str) -> _Region:
        return _Region(self, name)

    # ---------------------------------------------------------- counting
    def _add(self, name: str, flops: float, nbytes: float, shape) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op.get(name)
        if row is None:
            row = self.by_op[name] = {"count": 0, "flops": 0.0, "bytes": 0.0}
        row["count"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        if nbytes:
            site = self._sites.get((name, shape))
            if site is None:
                site = self._sites[(name, shape)] = [0, 0.0]
            site[0] += 1
            site[1] += nbytes

    def _freed(self, key, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _track(self, t: torch.Tensor, input_keys) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in input_keys or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(st, self._freed, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._hidden:
            return out
        name = func._overloadpacket.__name__
        ins = _tensors(args) + _tensors(list(kwargs.values()))
        outs = _tensors(out)
        in_keys = {k for k in map(_storage_key, ins) if k is not None}
        kind = _COLL.get(name)
        if kind is not None:
            self._collective(func, kind, args, outs)
            return out
        out_keys = [_storage_key(t) for t in outs]
        writes = any(r.alias_info is not None and r.alias_info.is_write for r in func._schema.returns)
        if outs and not writes and all(k is not None and k in in_keys for k in out_keys):
            # a view (its outputs alias its inputs: view, expand, t,
            # detach, _unsafe_view, ...) launches nothing
            self._add(name, 0.0, 0.0, None)
            return out
        for t, k in zip(outs, out_keys):
            if k is not None:
                self._track(t, in_keys)
        if name in ("_to_copy", "copy_", "copy") and ins and outs and ins[-1].device != outs[0].device:
            self.transfer_bytes += _nbytes(ins[-1])
            self._add(name, 0.0, 0.0, None)
            return out
        self._add(name, self._flops(name, args, ins, outs), self._bytes(name, ins, outs),
                  tuple(outs[0].shape) if outs else None)
        return out

    def _collective(self, func, kind: str, args, outs: list) -> None:
        """One collective: ``c10d``'s ops take their output buffers (or, for
        an all-reduce or broadcast, the tensors they update) first; the
        functional ones return their result."""
        n = _group_size(args)
        if func.namespace == "c10d":
            res = sum(map(_nbytes, _tensors(args[0])))
            others = sum(map(_nbytes, _tensors(list(args[1:]))))
        else:
            res = sum(map(_nbytes, outs))
            others = sum(map(_nbytes, _tensors(list(args))))
        moved = ring_moved_bytes(kind, res, n)
        self.coll[kind]["count"] += 1
        self.coll[kind]["moved_bytes"] += moved
        site = self._coll_sites.get((kind, n, res))
        if site is None:
            site = self._coll_sites[(kind, n, res)] = [0, 0.0]
        site[0] += 1
        site[1] += moved
        # read the inputs, write the result (an in-place one reads it too)
        self._add(func._overloadpacket.__name__, 0.0, float(res + (others or res)), None)

    @staticmethod
    def _flops(name: str, args, ins: list, outs: list) -> float:
        if name in _ZERO_FLOP or name in _GATHER or name in _SCATTER or not outs:
            return 0.0
        res = outs[0].numel()
        if name in _MATMUL:
            a = args[1] if name in ("addmm", "baddbmm", "addbmm", "addmv", "_addmm_activation") else args[0]
            contract = a.shape[-1] if a.dim() else 1
            if name == "addbmm":
                contract *= a.shape[0]
            extra = res if name in ("addmm", "baddbmm", "addbmm", "addmv", "_addmm_activation") else 0
            return 2.0 * res * contract + extra
        if name in _CONV:
            return _conv_flops(outs[0], args[1])
        if name in _CONV_BWD:
            grad_out, weight = args[0], args[2]
            fwd = _conv_flops(grad_out, weight)
            mask = args[-1] if isinstance(args[-1], (list, tuple)) else (True, True, True)
            return fwd * (int(bool(mask[0])) + int(bool(mask[1]))) + (grad_out.numel() if mask[2] else 0)
        if name in _SORT:
            x = ins[0]
            dim = args[1] if len(args) > 1 and isinstance(args[1], int) and name != "topk" else -1
            n = x.shape[dim] if x.dim() else 1
            return float(x.numel()) * max(math.log2(max(n, 2)), 1.0)
        if name in _REDUCE:
            return float(max(ins[0].numel(), res)) if ins else float(res)
        return float(sum(t.numel() for t in outs))

    @staticmethod
    def _bytes(name: str, ins: list, outs: list) -> float:
        if name in _NO_BYTES:
            return 0.0
        if name in _WRITE_ONLY:
            return float(sum(map(_nbytes, outs)))
        if name in ("copy_", "copy"):
            return float(_nbytes(ins[-1]) + _nbytes(outs[0])) if outs else 0.0
        if name in _GATHER:
            return 2.0 * sum(map(_nbytes, outs))
        if name in _SCATTER:
            if not ins:
                return 0.0
            upd = 3.0 * _nbytes(ins[-1])
            if name.endswith("_"):
                return upd
            return upd + _nbytes(ins[0]) + sum(map(_nbytes, outs))
        return float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))

    # ---------------------------------------------------------- result
    def result(self) -> dict:
        """The count, under ``hlo_cost.analyze``'s keys where they mean the
        same, plus ``peak_live_bytes``, ``transfer_bytes`` and ``by_op``."""
        top = sorted(self._sites.items(), key=lambda kv: -kv[1][1])[:_TOP]
        top_coll = sorted(self._coll_sites.items(), key=lambda kv: -kv[1][1])[:_TOP]
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "coll": {k: dict(v) for k, v in self.coll.items()},
            "coll_total_moved_bytes": sum(v["moved_bytes"] for v in self.coll.values()),
            "top_bytes": [{"kind": k[0], "shape": list(k[1]) if k[1] is not None else None, "count": c, "bytes": b}
                          for k, (c, b) in top],
            "top_collectives": [{"kind": k[0], "group": k[1], "result_bytes": k[2], "count": c, "moved_bytes": m}
                                for k, (c, m) in top_coll],
            "peak_live_bytes": self.peak_live_bytes,
            "transfer_bytes": self.transfer_bytes,
            "by_op": {k: dict(v) for k, v in sorted(self.by_op.items(), key=lambda kv: -kv[1]["bytes"])},
        }


def _conv_flops(result: torch.Tensor, weight: torch.Tensor) -> float:
    """``hlo_cost._conv_flops``: 2 x prod(result) x prod(kernel) / out_features,
    at least 2 x prod(result). ``weight`` is (C_out, C_in / groups, *k)."""
    out_feat = weight.shape[0]
    return 2.0 * result.numel() * max(weight.numel() / max(out_feat, 1), 1.0)
