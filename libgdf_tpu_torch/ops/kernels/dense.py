"""H5 `dense_groupby` and its `domain_probe`: a group-by over a small
integer key domain in one pass, without a sort; H7 `wide_groupby`: the
same over a wide domain, through slot arrays in device memory.

Wrappers around `csrc/dense_groupby.cu` (which says what bounds them and
what their design does about it; they replace no TPU kernel), each beside
its plain PyTorch version. On CPU tensors a wrapper runs the plain version;
on CUDA tensors it launches the kernel or raises.

  request(keys, columns, aggs, dropna, num_rows)
      the `Plan` of a group-by (its domain not yet probed), or None where
      the input needs a sort: a key that is no integer column, or is
      nullable under dropna=False; an op other than sum, count and avg, or
      a sum or avg of a column that is no number; more accumulators or
      outputs than H5 holds. `Plan.over(bounds, sort_bytes)` gives it the
      domain, or None where neither H5 nor H7 takes it.
  domain_probe(keys, row_ok, num_rows)
      int64 [K, 2]: each key's (min, max) over the rows below `num_rows`
      whose keys are all valid (`row_ok`); min > max where no row is. One
      memset of a ticket and one launch.
  dense_groupby(plan)
      the group-by of a `Plan` whose keys span D = prod(span) <= 8 slots:
      one pass adds every live row into per-slot accumulators
      (`Acc`: accumulator 0 counts the rows, the others are an int64 sum,
      a float64 sum or a count of a column's valid values), and the
      occupied slots, in slot order (key order), become the groups: each
      `Out` column's first G rows, padded to the capacity, `live` (True
      for the G groups), the validity of a nullable column's aggregates
      (its count > 0) and G as a 0-d int32 tensor. One zeroing of `live`
      (and of each validity array), one memset of a ticket, one launch.
  wide_groupby(plan)
      the same for a `Plan` of D > 8 slots (`Plan.wide`): slot arrays of
      D x `Plan.slot_bytes` bytes, set, added into by runs of adjacent rows
      of one slot, and compacted in slot order. One zeroing of `live` (and
      of each validity array), one memset of the look-back's descriptors,
      three launches.

A float sum reads a denormal as zero (in its own dtype, before a float32
widens); integer sums wrap. An average is the sum over max(count, 1) in
float64, from the float64 sum as it stands, or (`exact`) from the sum as a
column of its dtype holds it, flushed: the sort path's deferred average.
H5 adds in a fixed order, so its sums are the same from run to run; H7's
are where each group's rows are adjacent and fewer than a warp's chunk
(each group then reaches its slot from at most two warps, and two addends
commute); the plain version adds in row order.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, replace

import torch

from ...core.bits import flush_denormals
from . import _lib
from ._lib import DTYPE_CODES

MAX_KEYS = 8
MAX_SLOTS = 8
MAX_ACCS = 8
MAX_OUTS = 24

KEY_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
              torch.uint8, torch.bool)
VALUE_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
                torch.float32, torch.float64)

ROWS, VALID, INT_SUM, FLOAT_SUM = range(4)     # accumulator kinds
KEY, SUM, COUNT, AVG = range(4)                # output kinds


@dataclass(frozen=True)
class Acc:
    """A per-slot accumulator: ROWS (the rows; accumulator 0), VALID (the
    rows where `valid`), INT_SUM / FLOAT_SUM (`values` where `valid`)."""
    kind: int
    values: torch.Tensor | None = None
    valid: torch.Tensor | None = None


@dataclass(frozen=True)
class Out:
    """An output column. KEY: key `src`, in `dtype`; SUM: accumulator
    `src` in `dtype`; COUNT: accumulator `count`, int64; AVG: accumulator
    `src` over accumulator `count`, float64, `dtype` being its sum
    column's. `nullable`: valid where accumulator `count` > 0."""
    kind: int
    src: int
    dtype: torch.dtype
    count: int = 0
    nullable: bool = False
    exact: bool = False


@dataclass(frozen=True)
class Plan:
    """One group-by: `keys` (1-D, the capacity long), the rows whose keys
    are all valid (`row_ok`, None: all), the live row count (`num_rows`,
    None: all), and, once probed, each key's minimum `lo` and `span`."""
    keys: tuple
    row_ok: torch.Tensor | None
    num_rows: torch.Tensor | None
    accs: tuple
    outs: tuple
    lo: tuple = ()
    span: tuple = ()

    @property
    def capacity(self) -> int:
        return self.keys[0].shape[0]

    @property
    def slots(self) -> int:
        return math.prod(self.span)

    @property
    def wide(self) -> bool:
        """Whether the domain is H7's (more than H5's MAX_SLOTS slots)."""
        return self.slots > MAX_SLOTS

    @property
    def slot_bytes(self) -> int:
        """Bytes of one of H7's slots: the rows (int32) and each further
        accumulator (8 bytes)."""
        return 4 + 8 * (len(self.accs) - 1)

    def out_dtype(self, o: Out) -> torch.dtype:
        return {COUNT: torch.int64, AVG: torch.float64}.get(o.kind, o.dtype)

    def over(self, bounds, sort_bytes: int):
        """This plan over the domain of `bounds`, each key's (min, max) as
        `domain_probe` gives them, or None where the domain holds no row,
        or is wider than MAX_SLOTS slots and H7's slot arrays would take
        more bytes than `sort_bytes`, the sort path's own buffers for this
        input."""
        lo = tuple(b[0] for b in bounds)
        span = tuple(b[1] - b[0] + 1 for b in bounds)
        if min(span) < 1:
            return None
        plan = replace(self, lo=lo, span=span)
        if plan.wide and plan.slots * plan.slot_bytes > sort_bytes:
            return None
        return plan


OPS = ("sum", "count", "avg")


def request(keys, columns, aggs, dropna: bool, num_rows=None):
    """The plan of a group-by by `keys` ((data, valid) each) of `aggs`
    ((column, op[, name]) each, over `columns`: {name: (data, valid)}),
    without its domain, or None where the input needs the sort path."""
    if not 0 < len(keys) <= MAX_KEYS or not 0 < len(keys[0][0]) < 2 ** 31:
        return None
    if any(d.dtype not in KEY_DTYPES or (v is not None and not dropna)
           for d, v in keys):
        return None
    if any(spec[1] not in OPS for spec in aggs):
        return None
    accs, index = [Acc(ROWS)], {}

    def acc(name, kind):
        if (name, kind) not in index:
            data, valid = columns[name]
            index[(name, kind)] = len(accs)
            accs.append(Acc(kind, None if kind == VALID else data, valid))
        return index[(name, kind)]

    sums = {s[0] for s in aggs if s[1] == "sum"}
    counts = {s[0] for s in aggs if s[1] == "count"}
    outs = [Out(KEY, j, d.dtype) for j, (d, _) in enumerate(keys)]
    for spec in aggs:
        name, op = spec[0], spec[1]
        data, valid = columns[name]
        nullable = valid is not None
        cnt = acc(name, VALID) if nullable else 0
        if op == "count":
            outs.append(Out(COUNT, 0, torch.int64, cnt))
            continue
        if data.dtype not in VALUE_DTYPES:
            return None
        # avg from sibling sum and count divides the sum column as it
        # stands (the sort path's deferred avg); else a float64 sum
        exact = op == "sum" or (name in sums and name in counts)
        kind = (FLOAT_SUM if data.dtype.is_floating_point or not exact
                else INT_SUM)
        outs.append(Out(SUM if op == "sum" else AVG, acc(name, kind),
                        data.dtype, cnt, nullable, op == "avg" and exact))
    if len(accs) > MAX_ACCS or len(outs) > MAX_OUTS:
        return None
    row_ok = None
    for _, valid in keys:
        if valid is not None:
            row_ok = valid if row_ok is None else row_ok & valid
    return Plan(keys=tuple(d for d, _ in keys), row_ok=row_ok,
                num_rows=num_rows, accs=tuple(accs), outs=tuple(outs))


# -- plain versions -------------------------------------------------------------

def _live(n, num_rows, row_ok, device):
    ok = torch.ones(n, dtype=torch.bool, device=device)
    if num_rows is not None:
        ok = torch.arange(n, device=device) < num_rows
    return ok if row_ok is None else ok & row_ok


def domain_probe_plain(keys, row_ok, num_rows):
    """Plain version of `domain_probe`: min and max of the selected rows."""
    ok = _live(keys[0].shape[0], num_rows, row_ok, keys[0].device)
    big = torch.iinfo(torch.int64)
    return torch.stack([
        torch.stack([torch.where(ok, k.to(torch.int64), big.max).min(),
                     torch.where(ok, k.to(torch.int64), big.min).max()])
        for k in keys])


def _held_sum(tot, kind, dtype):
    """A slot total as a sum column of `dtype` holds it, as float64."""
    if kind == FLOAT_SUM:
        return flush_denormals(tot.to(dtype)).to(torch.float64)
    return tot.to(dtype).to(torch.float64)


def _slot_totals(plan: Plan):
    """Each accumulator's [D] slot totals."""
    n, dev, d = plan.capacity, plan.keys[0].device, plan.slots
    ok = _live(n, plan.num_rows, plan.row_ok, dev)
    slot = torch.zeros(n, dtype=torch.int64, device=dev)
    for k, lo, span in zip(plan.keys, plan.lo, plan.span):
        slot = slot * span + (k.to(torch.int64) - lo)
    totals = []
    for acc in plan.accs:
        take = ok if acc.valid is None or acc.kind == ROWS else ok & acc.valid
        idx = torch.where(take, slot, d)          # slot d collects the rest
        if acc.kind == FLOAT_SUM:
            x = flush_denormals(acc.values).to(torch.float64)
            tot = torch.full((d + 1,), -0.0, dtype=torch.float64, device=dev)
        elif acc.kind == INT_SUM:
            x = acc.values.to(torch.int64)
            tot = torch.zeros(d + 1, dtype=torch.int64, device=dev)
        else:
            x = torch.ones(n, dtype=torch.int64, device=dev)
            tot = torch.zeros(d + 1, dtype=torch.int64, device=dev)
        totals.append(tot.index_add_(0, idx, x)[:d])
    return totals


def dense_groupby_plain(plan: Plan):
    """Plain version of `dense_groupby`: index_add into the slots, then the
    occupied slots in order; the padding is zero."""
    n, dev = plan.capacity, plan.keys[0].device
    totals = _slot_totals(plan)
    occupied = torch.nonzero(totals[0] > 0).flatten()
    g = occupied.shape[0]
    strides = [math.prod(plan.span[j + 1:]) for j in range(len(plan.span))]
    outs, oks = [], []
    for o in plan.outs:
        if o.kind == KEY:
            v = plan.lo[o.src] + occupied // strides[o.src] % plan.span[o.src]
        elif o.kind == SUM:
            v = totals[o.src][occupied]
        elif o.kind == COUNT:
            v = totals[o.count][occupied]
        else:
            tot, kind = totals[o.src][occupied], plan.accs[o.src].kind
            num = (_held_sum(tot, kind, o.dtype) if o.exact
                   else tot.to(torch.float64))
            v = num / totals[o.count][occupied].clamp(min=1).to(torch.float64)
        out = torch.zeros(n, dtype=plan.out_dtype(o), device=dev)
        out[:g] = v.to(out.dtype)
        outs.append(out)
        ok = None
        if o.nullable:
            ok = torch.zeros(n, dtype=torch.bool, device=dev)
            ok[:g] = totals[o.count][occupied] > 0
        oks.append(ok)
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    live[:g] = True
    return outs, oks, live, torch.tensor(g, dtype=torch.int32, device=dev)


# -- the kernels ----------------------------------------------------------------

_P = ctypes.c_void_p
_L = ctypes.c_int64


class _CPlan(ctypes.Structure):
    """`Plan` in csrc/dense_groupby.cu, field for field."""
    _fields_ = [
        ("n", _L), ("num_rows", _P), ("row_ok", _P), ("nkeys", _L),
        ("key", _P * MAX_KEYS), ("key_dt", _L * MAX_KEYS),
        ("key_lo", _L * MAX_KEYS), ("key_span", _L * MAX_KEYS),
        ("nacc", _L), ("acc_kind", _L * MAX_ACCS), ("val", _P * MAX_ACCS),
        ("val_dt", _L * MAX_ACCS), ("val_ok", _P * MAX_ACCS),
        ("nout", _L), ("out_kind", _L * MAX_OUTS), ("out_src", _L * MAX_OUTS),
        ("out_cnt", _L * MAX_OUTS), ("out_dt", _L * MAX_OUTS),
        ("out_lo", _L * MAX_OUTS), ("out_exact", _L * MAX_OUTS),
        ("out", _P * MAX_OUTS), ("out_ok", _P * MAX_OUTS),
        ("live", _P), ("groups", _P),
    ]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _c_plan(n, keys, row_ok, num_rows) -> _CPlan:
    lib = _lib.lib()
    if lib.gdf_dense_plan_bytes() != ctypes.sizeof(_CPlan):
        raise RuntimeError("dense_groupby: the C plan's layout differs")
    c = _CPlan()
    c.n, c.num_rows, c.row_ok, c.nkeys = n, _ptr(num_rows), _ptr(row_ok), \
        len(keys)
    for j, k in enumerate(keys):
        c.key[j], c.key_dt[j] = k.data_ptr(), DTYPE_CODES[k.dtype]
    return c


def _tensors(what, keys, row_ok, num_rows, more=()):
    ts = [*keys, *more]
    ts += [t for t in (row_ok, num_rows) if t is not None]
    if all(t.device.type == "cpu" for t in ts):
        return None
    dev = _lib.require_cuda(what, *ts)
    if not 0 < keys[0].shape[0] < 2 ** 31:
        raise ValueError(f"{what}: 1 to 2^31 - 1 rows")
    for k in keys:
        if (k.dim() != 1 or k.shape != keys[0].shape
                or k.dtype not in DTYPE_CODES):
            raise ValueError(f"{what}: keys must be 1-D integer columns of "
                             "one length")
    if num_rows is not None and num_rows.dtype != torch.int32:
        raise ValueError(f"{what}: num_rows must be an int32 tensor")
    return dev


def _scratch(lib, fn, dev, *args):
    err = ctypes.c_int(0)
    nbytes = fn(*args, ctypes.byref(err))
    _lib.check(err.value, "dense_groupby scratch")
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def domain_probe(keys, row_ok=None, num_rows=None) -> torch.Tensor:
    """int64 [K, 2]: each key's (min, max) over the live rows whose keys
    are all valid; min > max where no row is."""
    keys = list(keys)
    if not 0 < len(keys) <= MAX_KEYS:
        raise ValueError(f"domain_probe: 1 to {MAX_KEYS} keys")
    dev = _tensors("domain_probe", keys, row_ok, num_rows)
    if dev is None:
        return domain_probe_plain(keys, row_ok, num_rows)
    lib = _lib.lib()
    out = torch.empty((len(keys), 2), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        c = _c_plan(keys[0].shape[0], keys, row_ok, num_rows)
        scratch = _scratch(lib, lib.gdf_domain_probe_scratch_bytes, dev,
                           keys[0].shape[0], len(keys))
        _lib.check(lib.gdf_domain_probe(
            ctypes.addressof(c), out.data_ptr(), scratch.data_ptr(),
            scratch.shape[0], _lib.stream_ptr(dev)), "domain_probe")
    _lib.count_launch(domain_probe)
    return out


domain_probe.launches = 0


def _check_plan(what, plan: Plan):
    """The plan's CUDA device, or None where every tensor is on the CPU."""
    if len(plan.span) != len(plan.keys) or min(plan.span) < 1:
        raise ValueError(f"{what}: a span of 1 or more a key")
    if not 1 <= len(plan.accs) <= MAX_ACCS or plan.accs[0].kind != ROWS:
        raise ValueError(f"{what}: 1 to {MAX_ACCS} accumulators, "
                         "the rows first")
    if len(plan.outs) > MAX_OUTS:
        raise ValueError(f"{what}: at most {MAX_OUTS} outputs")
    more = [t for a in plan.accs for t in (a.values, a.valid)
            if t is not None]
    return _tensors(what, list(plan.keys), plan.row_ok, plan.num_rows, more)


def _launch(what, plan: Plan, dev, scratch_args):
    """Outputs as the module says, from the library's `gdf_<what>` over the
    plan's C form (its keys of span >= 2 only: the others are constants)
    and the scratch that `gdf_<what>_scratch_bytes(*scratch_args)` asks
    for."""
    n = plan.capacity
    read = [j for j, s in enumerate(plan.span) if s > 1]
    c = _c_plan(n, [plan.keys[j] for j in read], plan.row_ok, plan.num_rows)
    for i, j in enumerate(read):
        c.key_lo[i], c.key_span[i] = plan.lo[j], plan.span[j]
    c.nacc = len(plan.accs)
    for a, acc in enumerate(plan.accs):
        c.acc_kind[a] = acc.kind
        if acc.values is not None:
            c.val[a] = acc.values.data_ptr()
            c.val_dt[a] = DTYPE_CODES[acc.values.dtype]
        c.val_ok[a] = _ptr(acc.valid)
    outs, oks, shared = [], [], {}
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    c.nout = len(plan.outs)
    for i, o in enumerate(plan.outs):
        out = torch.empty(n, dtype=plan.out_dtype(o), device=dev)
        ok = None
        if o.nullable:
            if o.count not in shared:
                shared[o.count] = torch.zeros(n, dtype=torch.bool, device=dev)
            ok = shared[o.count]
        outs.append(out)
        oks.append(ok)
        c.out_kind[i], c.out_cnt[i], c.out_exact[i] = o.kind, o.count, o.exact
        c.out_dt[i] = DTYPE_CODES[o.dtype]
        c.out[i], c.out_ok[i] = out.data_ptr(), _ptr(ok)
        if o.kind == KEY:
            c.out_src[i] = read.index(o.src) if o.src in read else -1
            c.out_lo[i] = plan.lo[o.src]
        else:
            c.out_src[i] = o.src
    groups = torch.empty((), dtype=torch.int32, device=dev)
    c.live, c.groups = live.data_ptr(), groups.data_ptr()
    lib = _lib.lib()
    with torch.cuda.device(dev):
        scratch = _scratch(lib, getattr(lib, f"gdf_{what}_scratch_bytes"),
                           dev, *scratch_args)
        _lib.check(getattr(lib, f"gdf_{what}")(
            plan.slots, ctypes.addressof(c), scratch.data_ptr(),
            scratch.shape[0], _lib.stream_ptr(dev)), what)
    return outs, oks, live, groups


def dense_groupby(plan: Plan):
    """Returns (outputs, validity arrays (None where the output is not
    nullable), live, group count) as the module says."""
    dev = _check_plan("dense_groupby", plan)
    if plan.wide:
        raise ValueError(f"dense_groupby: 1 to {MAX_SLOTS} slots")
    if dev is None:
        return dense_groupby_plain(plan)
    got = _launch("dense_groupby", plan, dev,
                  (plan.slots, len(plan.accs), plan.capacity))
    _lib.count_launch(dense_groupby)
    return got


dense_groupby.launches = 0


def wide_groupby(plan: Plan):
    """`dense_groupby` of a plan over more than MAX_SLOTS slots (H7)."""
    dev = _check_plan("wide_groupby", plan)
    if not plan.wide:
        raise ValueError(f"wide_groupby: more than {MAX_SLOTS} slots")
    if dev is None:
        return dense_groupby_plain(plan)
    got = _launch("wide_groupby", plan, dev, (plan.slots, len(plan.accs)))
    _lib.count_launch(wide_groupby)
    return got


wide_groupby.launches = 0
