"""Collective, memory and flop accounting of one step of the port, counted
while the step runs (counterpart of `repro.launch.hlo_analysis`).

The JAX package parses the compiled step's HLO text: per-device operand
bytes of each all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute, and XLA's memory and cost analyses. The port compiles
no graph, so `record_step(fn, *args)` runs the step once under three
`TorchDispatchMode`s and keeps what they saw:

- every `c10d` op (the port's collectives all go through
  `torch.distributed`, which dispatches them as ops, autograd's backward
  included): its kind, its operand bytes on this rank (an all-gather's
  input shard, an all-reduce's tensor, a reduce-scatter's whole input, as
  the HLO convention), its dtype and its site -- the port's function that
  called it (`sharding.MeshRank.gather`, `sharding._Gather.backward`,
  `decode._partial_attn`, ...). A collective over a group of one rank moves
  nothing and is not counted (XLA removes it);
- the bytes of every storage the step creates, live until its last tensor
  dies: the peak of those, above the arguments, is the step's temp bytes;
- `torch.utils.flop_counter.FlopCounterMode`'s flops: matrix products,
  convolutions and attention, forward and backward.

One difference is by design: HLO text shows a loop body's collective once
whatever its trip count, so JAX's totals understate a scanned model; the
port counts every call made, so its numbers are per step.

The dicts keep JAX's keys. A key with no counterpart here ("bytes
accessed", "transcendentals", "optimal_seconds", "alias_size_in_bytes",
"generated_code_size_in_bytes") is absent, never zero.
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

# c10d op -> (kind, index of its operand argument)
_OPS = {
    "_allgather_base_": ("all-gather", 1),
    "allgather_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
}
# the HLO dtype names of `repro.launch.hlo_analysis`
_HLO_DTYPES = {torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
               torch.int16: "s16", torch.bfloat16: "bf16", torch.float16: "f16",
               torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
               torch.float64: "f64"}
_DIST = str(Path(__file__).resolve().parents[1] / "distributed")
_TORCH = str(Path(torch.__file__).resolve().parent)


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _group_size(args) -> int:
    """The size of the process group among a c10d op's arguments."""
    from torch.distributed import ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).size()
            except RuntimeError:        # another bound object (a ReduceOp)
                continue
    return 0


def _site() -> str:
    """The port's function that made the collective: the outermost frame of
    the innermost run of frames in `repro_torch.distributed`, torch's own
    frames (c10d's wrappers, autograd's apply) passed through."""
    f, run = sys._getframe(2), None
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_DIST):
            run = f
        elif run is not None and not name.startswith(_TORCH):
            break
        f = f.f_back
    if run is None:
        return "?"
    code = run.f_code
    return f"{Path(code.co_filename).stem}.{getattr(code, 'co_qualname', code.co_name)}"


class _Collectives(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.records = []          # (bytes, kind, dtype, site)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            op = _OPS.get(func._opname)
            if op is not None and _group_size(args) > 1:
                kind, i = op
                ts = list(_tensors(args[i]))
                nbytes = sum(t.numel() * t.element_size() for t in ts)
                dtype = _HLO_DTYPES.get(ts[0].dtype, str(ts[0].dtype)) if ts else "?"
                self.records.append((nbytes, kind, dtype, _site()))
        return func(*args, **(kwargs or {}))


class _LiveBytes(TorchDispatchMode):
    """The bytes of the storages made inside the mode, each counted until
    the last tensor on it that the mode saw dies; `exempt` the storages of
    the arguments."""

    def __init__(self, exempt):
        super().__init__()
        self.exempt = {t.untyped_storage()._cdata for t in exempt}
        self.held = {}             # storage -> [nbytes, tensors alive]
        self.live = self.peak = 0

    def _release(self, key):
        entry = self.held[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self.held[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.exempt:
                continue
            entry = self.held.get(key)
            if entry is None:
                entry = self.held[key] = [st.nbytes(), 0]
                self.live += entry[0]
                self.peak = max(self.peak, self.live)
            entry[1] += 1
            weakref.finalize(t, self._release, key)
        return out


def _storage_bytes(tree) -> int:
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


@dataclass
class StepRecord:
    """What one run of a step showed: the port's counterpart of a compiled
    executable and its HLO text."""
    result: object = None
    collectives: list = field(default_factory=list)   # (bytes, kind, dtype, site)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    flops: float = 0.0


def record_step(fn, *args, argument_bytes: int | None = None) -> StepRecord:
    """Run fn(*args) once and record its collectives, memory and flops.
    `argument_bytes` overrides the bytes of the arguments' storages (a
    caller whose arguments hold more than the rank's local inputs, as a
    global batch that the step cuts to the rank's rows)."""
    live = _LiveBytes(list(_tensors(args)))
    comm = _Collectives()
    flops = FlopCounterMode(display=False)
    with flops, live, comm:
        result = fn(*args)
    return StepRecord(result=result, collectives=comm.records,
                      argument_bytes=(_storage_bytes(args) if argument_bytes is None
                                      else int(argument_bytes)),
                      output_bytes=_storage_bytes(result), temp_bytes=live.peak,
                      flops=float(flops.get_total_flops()))


def collective_bytes(record: StepRecord) -> dict:
    """{op_kind: operand_bytes_summed} on this rank, with "_counts" and
    "_total", as the JAX package's."""
    totals: dict = defaultdict(int)
    counts: dict = defaultdict(int)
    for nbytes, kind, _dtype, _site in record.collectives:
        totals[kind] += nbytes
        counts[kind] += 1
    totals = dict(totals)
    totals["_counts"] = dict(counts)
    totals["_total"] = sum(v for k, v in totals.items() if not k.startswith("_"))
    return totals


def collective_bytes_by_site(record: StepRecord, top: int = 15) -> list:
    """(bytes, kind, dtype, site) of the largest collective sites, each site
    summed over its calls (JAX's view lists HLO instructions, each once)."""
    sums: dict = defaultdict(int)
    for nbytes, kind, dtype, site in record.collectives:
        sums[(kind, dtype, site)] += nbytes
    out = [(b, kind, dtype, site) for (kind, dtype, site), b in sums.items()]
    out.sort(reverse=True)
    return out[:top]


def memory_analysis_dict(record: StepRecord) -> dict:
    return {"argument_size_in_bytes": record.argument_bytes,
            "output_size_in_bytes": record.output_bytes,
            "temp_size_in_bytes": record.temp_bytes}


def cost_analysis_dict(record: StepRecord) -> dict:
    return {"flops": record.flops}
