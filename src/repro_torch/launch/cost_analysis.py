"""Per-device cost of a step laid out on DTensors: the port's counterpart
of the reference's ``repro.launch.hlo_analysis``.

The reference compiles a step for the production mesh and reads XLA's
per-device ``cost_analysis()``, ``memory_analysis()`` and the collectives
of the post-SPMD HLO text. The port has no compiler: it runs the step
eagerly on DTensors whose local shards are fake tensors (no memory is
allocated) over a ``fake`` process group, and :class:`StepRecorder`, a
dispatch mode, watches what one rank does below DTensor:

- **FLOPs**: every local op on one rank's shards, by
  ``torch.utils.flop_counter``'s formulas (with the CPU flash-attention
  entries counted as the CUDA ones). Elementwise work is not counted, as
  no ``flop_counter`` formula counts it; XLA's count does. An op on
  DTensors is let through to DTensor, which issues the local ops and the
  collectives that the mode then sees, so the count is per device and not
  the global op's.
- **Collectives**: each functional collective DTensor or the port's layers
  issue, as the reference's record ``{op: {count, result_bytes,
  wire_bytes}}`` under the reference's op names, with the reference's ring
  factors over the group size k (the size of the mesh dims it spans):

      all-reduce       2·(k−1)/k · result
      all-gather         (k−1)/k · result        (result = gathered tensor)
      reduce-scatter     (k−1)   · result        (result = scattered shard)
      all-to-all         (k−1)/k · result
      collective-permute          result

- **Bytes accessed**: the bytes each local op that is not a view reads
  and writes (its tensor inputs and outputs), the traffic of the unfused
  eager program; XLA's "bytes accessed" is per fusion.
- **Memory**: the peak of live bytes of the storages the step creates,
  beyond its arguments, as the eager program holds them (there is no
  buffer assignment, so this is not XLA's ``temp_size_in_bytes``).
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "c64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

aten = torch.ops.aten

# The CPU flash-attention entries count as their CUDA counterparts: the
# same two products.
EXTRA_FLOP_FORMULAS = {
    aten._scaled_dot_product_flash_attention_for_cpu:
        flop_registry[aten._scaled_dot_product_flash_attention],
    aten._scaled_dot_product_flash_attention_for_cpu_backward:
        flop_registry[aten._scaled_dot_product_flash_attention_backward],
}
FLOP_FORMULAS = {**flop_registry, **EXTRA_FLOP_FORMULAS}

# functional collective -> the reference's HLO op name
_FUNCOL_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# ops that read metadata only (``FlopCounterMode`` skips them too)
_META_OPS = {
    aten.sym_is_contiguous.default, aten.is_contiguous.default,
    aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.size.default,
    aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
    aten.storage_offset.default, aten.sym_storage_offset.default,
    aten.numel.default, aten.sym_numel.default, aten.dim.default,
    torch.ops.prim.layout.default, torch.ops.prim.device.default,
}


def _wire_factor(op: str, k: int) -> float:
    if op == "all-reduce":
        return 2.0 * (k - 1) / k
    if op == "all-gather":
        return (k - 1) / k
    if op == "reduce-scatter":
        return float(k - 1)
    if op == "all-to-all":
        return (k - 1) / k
    return 1.0  # collective-permute


def aggregate(events: Iterable[Tuple[str, int, int]]
              ) -> Dict[str, Dict[str, float]]:
    """{op: {count, result_bytes, wire_bytes}} from (op, result bytes,
    group size k) events, as the reference's ``parse_collectives``."""
    out: Dict[str, Dict[str, float]] = {}
    for op, nbytes, k in events:
        if op not in _COLLECTIVES:
            raise ValueError(f"unknown collective {op!r}")
        if nbytes == 0:
            continue
        rec = out.setdefault(op, {"count": 0, "result_bytes": 0.0,
                                  "wire_bytes": 0.0})
        rec["count"] += 1
        rec["result_bytes"] += nbytes
        rec["wire_bytes"] += nbytes * _wire_factor(op, k)
    return out


def total_wire_bytes(collectives: Dict[str, Dict[str, float]]) -> float:
    return sum(rec["wire_bytes"] for rec in collectives.values())


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's elements; a DTensor's local shard."""
    local = getattr(t, "_local_tensor", t)
    return local.numel() * local.element_size()


def _tensors(tree: Any) -> Iterable[torch.Tensor]:
    """The tensors of a nested dict / tuple / list."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor in a nested dict / tuple / list."""
    return sum(tensor_bytes(t) for t in _tensors(tree))


def _group_size(op_name: str, args) -> int:
    if op_name in ("all_gather_into_tensor", "reduce_scatter_tensor",
                   "all_gather_into_tensor_coalesced",
                   "reduce_scatter_tensor_coalesced"):
        return int(args[-2])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


class StepRecorder(TorchDispatchMode):
    """Counts one rank's local FLOPs, collectives and live bytes while it
    is entered (see the module docstring). ``arguments`` are the step's
    inputs: their storages are live before the step and are not counted.
    Read :attr:`flops`, :attr:`bytes_accessed`, :meth:`collectives` and
    :attr:`peak_bytes` after the block."""

    def __init__(self, arguments: Any = ()) -> None:
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.events = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: Dict[int, int] = {}
        self._depth = self._shadow = 0
        for t in _tensors(arguments):
            st = getattr(t, "_local_tensor", t).untyped_storage()
            self._seen[st._cdata] = 0

    def __enter__(self):
        # DTensor infers an op's global output shape by running the op on
        # global-shaped fake tensors; those shadow ops are no rank's work.
        # The mode re-enters itself (decompositions): patch once.
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator

        if self._depth == 0:
            prop, rec = ShardingPropagator._propagate_tensor_meta_non_cached, \
                self

            def shadowed(*args, **kwargs):
                rec._shadow += 1
                try:
                    return prop(*args, **kwargs)
                finally:
                    rec._shadow -= 1
            self._prop = prop
            ShardingPropagator._propagate_tensor_meta_non_cached = shadowed
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator

        self._depth -= 1
        if self._depth == 0:
            ShardingPropagator._propagate_tensor_meta_non_cached = self._prop
        return super().__exit__(*exc)

    def collectives(self) -> Dict[str, Dict[str, float]]:
        return aggregate(self.events)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._seen.pop(key, 0)

    def _track(self, out) -> None:
        from torch.distributed.tensor import DTensor

        for t in _tensors(out):
            if isinstance(t, DTensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = int(st.nbytes())
            self._seen[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run: its local ops and collectives come back here
            return NotImplemented
        if func in _META_OPS:
            return NotImplemented
        if self._shadow:
            return func(*args, **kwargs)
        if func not in FLOP_FORMULAS:
            # a composite op is counted through its decomposition, as
            # FlopCounterMode counts it
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if not func.is_view:
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in _tensors((args, kwargs, out)))
        if packet in FLOP_FORMULAS:
            self.flops += int(FLOP_FORMULAS[packet](*args, **kwargs,
                                                    out_val=out))
        if func.namespace == "_c10d_functional":
            name = packet.__name__
            if name in _FUNCOL_OPS:
                # one instruction, its results summed (a coalesced op's
                # tuple, as the reference reads a tuple-shaped result)
                self.events.append((_FUNCOL_OPS[name],
                                    sum(t.numel() * t.element_size()
                                        for t in _tensors(out)),
                                    _group_size(name, args)))
            elif name != "wait_tensor":
                raise NotImplementedError(f"collective {func} not recorded")
        self._track(out)
        return out
