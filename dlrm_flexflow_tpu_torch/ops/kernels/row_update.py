"""Sparse embedding row updates: CUDA kernel wrappers and plain versions.

Replaces the Pallas TPU kernels `_update_kernel` and `_update_kernel_manual`
(`dlrm_flexflow_tpu/ops/pallas/packed_update.py:487,750`, launched by
`_packed_apply` and `_packed_apply_manual` through
`packed_row_update_batched`, `:1011`, and, in K1's decay mode, through
`packed_lazy_adam_batched` and `packed_lazy_momentum_batched`,
`:1069,1162`). Four rules, one wrapper each, each with a launch count:

  row_update           table[rows[k]] += round_s(scale * src[k // h]), the
                       SGD rule and the plain sum (K1, K2);
  row_update_momentum  lazy momentum and Nesterov on a [V, D] f32 velocity;
  row_update_adam      lazy Adam on two [V, D] f32 pools, m and v;
  row_update_adagrad   row-wise AdaGrad on a [V] f32 accumulator.

Every rule sums a row's duplicate entries in f32, drops rows < 0 or >= V
(their table and pool rows stay as they are), rounds each stream entry to
bf16 (the SGD rule: to the stream dtype), and ends with the table dtype's
epilogue: an f32 table adds the f32 sum; a bf16 table adds the sum rounded
to bf16, in bf16 (`tp + acc.astype(tp.dtype)`, `:558`). The arithmetic of
each rule is written out in `csrc/row_update.cu`; the plain versions here
repeat it operation by operation. The payload is `(src [B, D], h)`: entry k
reads `src[k // h]` (the unexpanded pooled gradient of `bag_row_src`), or a
`[K, D]` tensor, which is the same with h = 1. Tables and pools are updated
in place.

On CUDA the rows are prepared in torch, as the JAX package prepares its
stream outside Pallas (`prep_sorted_routes`, `:238`): dropped rows map to
the sentinel V, and one stable sort over the group's [T, K] rows gives
`rows_sorted, order` (`sort_rows`, which counts its calls in
`sort_rows.calls`). Under host routing the caller passes those two per
table instead (`routes`, from `FFModel.compute_routes`: the same keys
sorted stably on the host, so the same order), and nothing is sorted on
the device. Then the kernel updates each table (one wrapper launch,
counted once, of two CUDA launches, four for AdaGrad): the sorted stream
is cut into fixed chunks of `CHUNK` positions, each run piece is summed in
sorted order, a run that crosses chunk edges is summed over its pieces in
chunk order, and each row and its pool rows are written once: no atomics,
the same bits on every run. The wrapper allocates the kernel's scratch
(`scratch_floats`). On the CPU the plain version runs (given
routes are checked, then not needed): dropped-row mask, `torch.unique`,
`index_add_` of the rounded entries into f32 zeros, then the rule's
epilogue.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from ... import _build

MAX_D = 128  # the kernel's limit on D (csrc/row_update.cu)
CHUNK = 64  # sorted positions a chunk (csrc/row_update.cu kChunk; checked at launch)

Payload = Union[torch.Tensor, Tuple[torch.Tensor, int]]

F32, BF16 = torch.float32, torch.bfloat16


def _src_h(payload: Payload) -> Tuple[torch.Tensor, int]:
    if isinstance(payload, tuple):
        src, h = payload
        return src, int(h)
    return payload, 1


def _bf16r(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16).float()


def _f32(x: float) -> float:
    """x rounded to f32 (a constant the JAX package takes weakly typed)."""
    return float(np.float32(x))


def _keep(beta: float) -> float:
    """1 - (1 - beta) in f32, as K1's decay epilogue takes it: `1.0 - decay
    * 1.0` with decay = 1 - beta rounded to f32 (`packed_update.py:551-556`)."""
    return float(np.float32(1.0) - np.float32(1.0 - beta))


def _entries(table: torch.Tensor, rows: torch.Tensor, payload: Payload, weight_decay: float = 0.0):
    """The kept entries as (uniq, inv, g, src_rows): the distinct kept rows,
    each entry's slot among them, each entry's f32 gradient (plus the weight
    decay term wd * t[r] taken in the table's dtype), and its payload row."""
    src, h = _src_h(payload)
    keep = torch.nonzero((rows >= 0) & (rows < table.shape[0])).reshape(-1)
    r = rows[keep].long()
    uniq, inv = torch.unique(r, return_inverse=True)
    g = src[keep // h].float()
    if weight_decay != 0.0:
        wd = torch.full((), weight_decay, dtype=table.dtype, device=table.device)
        g = g + (wd * table[r]).float()
    return uniq, inv, g, keep // h


def _run_sum(x: torch.Tensor, inv: torch.Tensor, n: int) -> torch.Tensor:
    """Per distinct row, the f32 sum of its entries' x."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=F32, device=x.device)
    return out.index_add_(0, inv, x)


def _add_to_table(table: torch.Tensor, uniq: torch.Tensor, acc: torch.Tensor) -> None:
    """The table dtype's epilogue on the touched rows."""
    if table.dtype == F32:
        table[uniq] = table[uniq] + acc
    else:
        table[uniq] = (table[uniq].float() + _bf16r(acc)).to(table.dtype)


def row_update_reference(
    table: torch.Tensor,
    rows: torch.Tensor,
    payload: Payload,
    scale: torch.Tensor,
    stream_dtype: torch.dtype = BF16,
) -> None:
    """Plain version of the SGD rule, in place: `index_add_` of the rounded
    deltas into an f32 copy of the touched rows, then the table dtype's
    epilogue."""
    src, h = _src_h(payload)
    v, d = table.shape
    keep = torch.nonzero((rows >= 0) & (rows < v)).reshape(-1)
    if keep.numel() == 0:
        return
    delta = (scale.float() * src[keep // h].float()).to(stream_dtype).float()
    uniq, inv = torch.unique(rows[keep].long(), return_inverse=True)
    _add_to_table(table, uniq, _run_sum(delta, inv, uniq.numel()))


def momentum_reference(table, vel, rows, payload, lr, momentum: float, nesterov: bool = False,
                       weight_decay: float = 0.0) -> None:
    """Plain version of lazy momentum, in place (`packed_lazy_momentum_batched`):
    vel' = vel * keep + sum bf16(g); step = vel', or (vel' - mu * vel) + mu *
    vel' with nesterov; t (+)= bf16(-lr * step)."""
    uniq, inv, g, _ = _entries(table, rows, payload, weight_decay)
    if uniq.numel() == 0:
        return
    acc = _run_sum(_bf16r(g), inv, uniq.numel())
    v_old = vel[uniq]
    v_new = v_old * _keep(momentum) + acc
    mu = _f32(momentum)
    step = (v_new - mu * v_old) + mu * v_new if nesterov else v_new
    vel[uniq] = v_new
    _add_to_table(table, uniq, _bf16r(-lr.float() * step))


def adam_reference(table, m, v, rows, payload, alpha_t, beta1: float, beta2: float,
                   epsilon: float, weight_decay: float = 0.0) -> None:
    """Plain version of lazy Adam, in place (`packed_lazy_adam_batched`):
    m' = m * keep1 + sum bf16(c1 * g), v' = v * keep2 + sum bf16(c2 * g^2),
    t (+)= bf16((-alpha_t * m') / (sqrt(v') + eps))."""
    uniq, inv, g, _ = _entries(table, rows, payload, weight_decay)
    if uniq.numel() == 0:
        return
    n = uniq.numel()
    acc_m = _run_sum(_bf16r(_f32(1.0 - beta1) * g), inv, n)
    acc_v = _run_sum(_bf16r(_f32(1.0 - beta2) * (g * g)), inv, n)
    m_new = m[uniq] * _keep(beta1) + acc_m
    v_new = v[uniq] * _keep(beta2) + acc_v
    m[uniq] = m_new
    v[uniq] = v_new
    _add_to_table(table, uniq, _bf16r((-alpha_t.float() * m_new) / (torch.sqrt(v_new) + _f32(epsilon))))


def adagrad_reference(table, accum, rows, payload, lr, epsilon: float) -> None:
    """Plain version of row-wise AdaGrad, in place (the JAX engine's two
    passes, `sparse_engine.py:160-199`): a' = a + sum mean_d(src^2) (f32,
    never rounded); s = -lr * rsqrt(a' + eps); t (+)= sum bf16(src * s)."""
    src, _ = _src_h(payload)
    uniq, inv, g, b = _entries(table, rows, payload)
    if uniq.numel() == 0:
        return
    gsq = torch.mean(src.float() * src.float(), dim=-1)[b]
    a_new = accum[uniq] + _run_sum(gsq, inv, uniq.numel())
    accum[uniq] = a_new
    scale = -lr.float() * torch.rsqrt(a_new + _f32(epsilon))
    _add_to_table(table, uniq, _run_sum(_bf16r(g * scale[inv][:, None]), inv, uniq.numel()))


# ------------------------------------------------------------------ CUDA

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def scratch_floats(k: int, d: int, rule: str) -> int:
    """Floats of f32 scratch one table's launch takes: the sums of the run
    pieces at chunk edges, [n_chunks, 2, n_acc, D] (n_acc = 2 for Adam's m
    and v, else 1), and for AdaGrad its mean-square partials and scales,
    [n_chunks, 2] each. The same count as the kernel's
    `row_update_scratch_floats`, which the launch checks."""
    n = -(-k // CHUNK)
    return n * 2 * (2 if rule == "adam" else 1) * d + (4 * n if rule == "adagrad" else 0)


@functools.lru_cache(maxsize=1)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("row_update")
    # (table, table is bf16, [pools], rows_sorted, order, src, rate ptr,
    #  [rule constants], K, V, D, h, [stream is bf16], scratch, its floats,
    #  CHUNK, cudaStream_t)
    tail = [_P, _LL, _I, _P]
    lib.row_update.argtypes = [_P, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _I] + tail
    lib.row_update_momentum.argtypes = [_P, _I, _P, _P, _P, _P, _P, _F, _F, _F, _I,
                                        _LL, _I, _I, _I] + tail
    lib.row_update_adam.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _F,
                                    _LL, _I, _I, _I] + tail
    lib.row_update_adagrad.argtypes = [_P, _I, _P, _P, _P, _P, _P, _F, _LL, _I, _I, _I] + tail
    for fn in (lib.row_update, lib.row_update_momentum, lib.row_update_adam,
               lib.row_update_adagrad):
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def sort_rows(tables: Sequence[torch.Tensor], rows_list: Sequence[torch.Tensor]):
    """The stream prep: rows out of [0, V) map to the sentinel V of their
    table; one stable sort over the group's [T, K] rows. Returns
    (rows_sorted, order), both [T, K] int32. Counts its calls in
    `sort_rows.calls`, so that a host-routed path can show it sorted
    nothing on the device."""
    sort_rows.calls += 1
    keyed = []
    for table, rows in zip(tables, rows_list):
        v = table.shape[0]
        r = rows.to(torch.int32)
        keyed.append(torch.where((r >= 0) & (r < v), r, torch.full_like(r, v)))
    rows_sorted, order = torch.sort(torch.stack(keyed), dim=1, stable=True)
    return rows_sorted, order.to(torch.int32)


def _call(name: str, rule: str, table, rows_sorted, *args) -> None:
    lib = _kernel_lib()
    n = scratch_floats(rows_sorted.numel(), table.shape[1], rule)
    scratch = torch.empty(n, dtype=F32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = getattr(lib, name)(*args, scratch.data_ptr(), n, CHUNK, stream)
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel failed: {msg} (cudaError {err})")


def _stream_args(table, rows_sorted, h):
    """(K, V, D, h) of one table's launch."""
    v, d = table.shape
    return rows_sorted.numel(), v, d, h


def _launch(table, rows_sorted, order, src, h, scale, stream_dtype) -> None:
    _call("row_update", "sgd", table, rows_sorted, table.data_ptr(), int(table.dtype == BF16),
          rows_sorted.data_ptr(), order.data_ptr(), src.data_ptr(), scale.data_ptr(),
          *_stream_args(table, rows_sorted, h), int(stream_dtype == BF16))
    row_update.launches += 1


def _launch_momentum(table, vel, rows_sorted, order, src, h, lr, momentum, nesterov,
                     weight_decay) -> None:
    _call("row_update_momentum", "momentum", table, rows_sorted, table.data_ptr(),
          int(table.dtype == BF16), vel.data_ptr(), rows_sorted.data_ptr(), order.data_ptr(),
          src.data_ptr(), lr.data_ptr(), _keep(momentum), _f32(momentum), _f32(weight_decay),
          int(nesterov), *_stream_args(table, rows_sorted, h))
    row_update_momentum.launches += 1


def _launch_adam(table, m, v, rows_sorted, order, src, h, alpha_t, beta1, beta2, epsilon,
                 weight_decay) -> None:
    _call("row_update_adam", "adam", table, rows_sorted, table.data_ptr(), int(table.dtype == BF16),
          m.data_ptr(), v.data_ptr(), rows_sorted.data_ptr(), order.data_ptr(), src.data_ptr(),
          alpha_t.data_ptr(), _f32(1.0 - beta1), _f32(1.0 - beta2), _keep(beta1), _keep(beta2),
          _f32(epsilon), _f32(weight_decay), *_stream_args(table, rows_sorted, h))
    row_update_adam.launches += 1


def _launch_adagrad(table, accum, rows_sorted, order, src, h, lr, epsilon) -> None:
    _call("row_update_adagrad", "adagrad", table, rows_sorted, table.data_ptr(),
          int(table.dtype == BF16), accum.data_ptr(), rows_sorted.data_ptr(), order.data_ptr(),
          src.data_ptr(), lr.data_ptr(), _f32(epsilon), *_stream_args(table, rows_sorted, h))
    row_update_adagrad.launches += 1


def _check(tables, rows_list, payloads, rate, pools=(), routes=None) -> None:
    """Shapes, dtypes, devices and contiguity of one grouped call. `rate` is
    the one f32 value on the device (scale, lr or alpha_t); `pools` a list
    of (per-table pools, shape of one: "row" [V, D] or "scalar" [V]);
    `routes` None or one (rows_sorted, order) per table, each [K] int32,
    contiguous, on the table's device."""
    if not (len(tables) == len(rows_list) == len(payloads)) or not tables:
        raise ValueError("row_update takes equal, non-empty lists of tables, rows and payloads")
    dev = tables[0].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"row_update runs on cuda or cpu, got {dev}")
    if rate.numel() != 1 or rate.dtype != F32 or rate.device != dev:
        raise ValueError("row_update: the rate must be one float32 value on the tables' device")
    k = rows_list[0].shape
    for i, (table, rows, payload) in enumerate(zip(tables, rows_list, payloads)):
        src, h = _src_h(payload)
        if table.dim() != 2 or table.dtype not in (F32, BF16):
            raise TypeError(f"row_update takes [V, D] float32 or bfloat16 tables, got "
                            f"{tuple(table.shape)} {table.dtype}")
        if not 1 <= table.shape[1] <= MAX_D or table.shape[0] >= 2**31 - 1:
            raise ValueError(f"row_update takes 1 <= D <= {MAX_D} and V < 2^31 - 1, "
                             f"got {tuple(table.shape)}")
        if rows.dim() != 1 or rows.shape != k or rows.dtype not in (torch.int32, torch.int64):
            raise ValueError("row_update: every table takes the same [K] integer rows")
        if src.dtype != F32 or src.dim() != 2 or src.shape[1] != table.shape[1]:
            raise TypeError("row_update: the payload must be float32 rows of the table's D")
        if h < 1 or src.shape[0] * h != rows.shape[0]:
            raise ValueError(f"row_update: payload of {src.shape[0]} rows x h={h} "
                             f"does not cover K={rows.shape[0]}")
        if not (table.is_contiguous() and src.is_contiguous()):
            raise ValueError("row_update needs contiguous tables and payloads")
        if any(t.device != dev for t in (table, rows, src)):
            raise ValueError("row_update: all tensors must lie on one device")
        for pool_list, kind in pools:
            pool = pool_list[i]
            want = tuple(table.shape) if kind == "row" else tuple(table.shape[:1])
            if (tuple(pool.shape) != want or pool.dtype != F32 or pool.device != dev
                    or not pool.is_contiguous()):
                raise ValueError(f"row_update: an optimizer pool must be a contiguous float32 "
                                 f"{list(want)} on the table's device, got {tuple(pool.shape)} "
                                 f"{pool.dtype} on {pool.device}")
    if routes is None:
        return
    if len(routes) != len(tables):
        raise ValueError(f"row_update: {len(routes)} routes for {len(tables)} tables")
    for route in routes:
        if len(route) != 2 or any(
            r.dim() != 1 or r.shape != k or r.dtype != torch.int32 or r.device != dev
            or not r.is_contiguous() for r in route
        ):
            raise ValueError(f"row_update: a route is (rows_sorted, order), each a contiguous "
                             f"[{k[0]}] int32 on {dev}, one per table")


def _grouped(tables, rows_list, payloads, routes=None):
    """On CUDA: each table's sorted stream, the given routes or one sort of
    the group's rows, with (src, h, i)."""
    if routes is None:
        rows_sorted, order = sort_rows(tables, rows_list)
        routes = list(zip(rows_sorted, order))
    for i, payload in enumerate(payloads):
        src, h = _src_h(payload)
        yield routes[i][0], routes[i][1], src, h, i


def row_update(
    tables: List[torch.Tensor],
    rows_list: Sequence[torch.Tensor],
    payloads: Sequence[Payload],
    scale: torch.Tensor,
    stream_dtype: torch.dtype = BF16,
    routes=None,
) -> None:
    """table[rows] += round_s(scale * payload) for each table of a group,
    in place; every table shares K and the scale. On CUDA it sorts the
    group's rows once (or takes the given `routes`, one (rows_sorted,
    order) a table) and launches the kernel once per table (counted in
    `row_update.launches`); on the CPU it takes the plain version."""
    _check(tables, rows_list, payloads, scale, routes=routes)
    if stream_dtype not in (BF16, F32):
        raise TypeError(f"row_update streams bfloat16 or float32, got {stream_dtype}")
    if not tables[0].is_cuda:
        for table, rows, payload in zip(tables, rows_list, payloads):
            row_update_reference(table, rows, payload, scale, stream_dtype)
        return
    if rows_list[0].numel() == 0:
        return
    for rows_s, order, src, h, i in _grouped(tables, rows_list, payloads, routes):
        _launch(tables[i], rows_s, order, src, h, scale, stream_dtype)


def row_update_momentum(tables, vels, rows_list, payloads, lr: torch.Tensor, momentum: float,
                        nesterov: bool = False, weight_decay: float = 0.0, routes=None) -> None:
    """Lazy momentum (or Nesterov) SGD on each table of a group and its
    [V, D] f32 velocity, in place; one launch per table on CUDA (counted in
    `row_update_momentum.launches`), the plain version on the CPU; `routes`
    as for `row_update`."""
    _check(tables, rows_list, payloads, lr, [(vels, "row")], routes)
    if not tables[0].is_cuda:
        for t, vel, rows, p in zip(tables, vels, rows_list, payloads):
            momentum_reference(t, vel, rows, p, lr, momentum, nesterov, weight_decay)
        return
    if rows_list[0].numel() == 0:
        return
    for rows_s, order, src, h, i in _grouped(tables, rows_list, payloads, routes):
        _launch_momentum(tables[i], vels[i], rows_s, order, src, h, lr, momentum, nesterov,
                         weight_decay)


def row_update_adam(tables, ms, vs, rows_list, payloads, alpha_t: torch.Tensor, beta1: float,
                    beta2: float, epsilon: float, weight_decay: float = 0.0, routes=None) -> None:
    """Lazy Adam on each table of a group and its [V, D] f32 m and v pools,
    in place, at the bias-corrected rate `alpha_t`; one launch per table on
    CUDA (counted in `row_update_adam.launches`), the plain version on the
    CPU; `routes` as for `row_update`."""
    _check(tables, rows_list, payloads, alpha_t, [(ms, "row"), (vs, "row")], routes)
    if not tables[0].is_cuda:
        for t, m, v, rows, p in zip(tables, ms, vs, rows_list, payloads):
            adam_reference(t, m, v, rows, p, alpha_t, beta1, beta2, epsilon, weight_decay)
        return
    if rows_list[0].numel() == 0:
        return
    for rows_s, order, src, h, i in _grouped(tables, rows_list, payloads, routes):
        _launch_adam(tables[i], ms[i], vs[i], rows_s, order, src, h, alpha_t, beta1, beta2,
                     epsilon, weight_decay)


def row_update_adagrad(tables, accums, rows_list, payloads, lr: torch.Tensor,
                       epsilon: float, routes=None) -> None:
    """Row-wise AdaGrad on each table of a group and its [V] f32
    accumulator, in place; one launch per table on CUDA (counted in
    `row_update_adagrad.launches`), the plain version on the CPU; `routes`
    as for `row_update`."""
    _check(tables, rows_list, payloads, lr, [(accums, "scalar")], routes)
    if not tables[0].is_cuda:
        for t, a, rows, p in zip(tables, accums, rows_list, payloads):
            adagrad_reference(t, a, rows, p, lr, epsilon)
        return
    if rows_list[0].numel() == 0:
        return
    for rows_s, order, src, h, i in _grouped(tables, rows_list, payloads, routes):
        _launch_adagrad(tables[i], accums[i], rows_s, order, src, h, lr, epsilon)


row_update.launches = 0
row_update_momentum.launches = 0
row_update_adam.launches = 0
row_update_adagrad.launches = 0
sort_rows.calls = 0
