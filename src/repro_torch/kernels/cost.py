"""The work of one call of each hand-written kernel: the bytes it must move
and the operations it must do, as functions of the call's shapes, element
size and (for the decode kernels) the keys it attends.

One count per kernel, read by everything that prices a kernel's work: the
wrappers' meta branch (a dry run on ``device="meta"`` adds the count of each
call it would launch to the active ``launch.cost.CostCounter``) and
``chip_smoke.py``'s bound column (``bound_ms``: the least time the card could
take, bytes over the memory rate against operations over the peak rate of
their type). So a kernel's roofline reads the same work whatever
implements it.

Bytes: every input read once and every output written once, whatever the
kernel reads again. Where the work depends on the data, the caller passes
what this call's data needs: ``keys``, the (batch row, key) pairs attended
(below ``valid_len``, and inside the window where one is set), and for the
paged kernels ``pages``, the block-table entries read. The scans' chunked
forms are counted at a fixed chunk, ``SCAN_CHUNK``, so that a kernel's own
chunk cannot move its count.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12, "tfloat32": 495e12, "bfloat16": 989e12}
SCAN_CHUNK = 64   # the chunked forms are counted at this chunk, whatever the kernels'


class Cost(NamedTuple):
    bytes: int        # bytes the call must move
    ops: int          # operations (a multiply-add counts two)
    dtype: str        # the peak rate they run at: a key of PEAK_OPS


def _float(elem: int) -> str:
    return "bfloat16" if elem == 2 else "float32"


def bound_ms(cost: Cost) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over HBM_BYTES_PER_S and
    operations over the peak of ``cost.dtype``, and which of them it is."""
    t_bytes = cost.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = cost.ops / PEAK_OPS[cost.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _gqa(b, h, kv, dk, dv, elem, keys, pages) -> Cost:
    """q, the K/V rows of ``keys``, valid_len, ``pages`` table entries and
    the output; 2 H (Dk + Dv) operations a key over the inputs' peak."""
    nbytes = b * h * dk * elem + keys * kv * (dk + dv) * elem + 4 * b + b * h * dv * elem
    if pages is not None:
        nbytes += 4 * pages
    return Cost(nbytes, 2 * keys * (h // kv) * kv * (dk + dv), _float(elem))


def decode_attention(b, h, kv, dk, dv, elem, keys) -> Cost:
    """Kernel 1, dense GQA decode: q (B,H,Dk) over ``keys`` rows of K/V."""
    return _gqa(b, h, kv, dk, dv, elem, keys, None)


def paged_decode_attention(b, h, kv, dk, dv, elem, keys, pages) -> Cost:
    """Kernel 2, paged GQA decode: as kernel 1, plus ``pages`` table entries."""
    return _gqa(b, h, kv, dk, dv, elem, keys, pages)


def _mla(b, h, rank, rope, elem, keys, pages) -> Cost:
    """q_lat and q_rope, the ckv and kr rows of ``keys``, valid_len,
    ``pages`` table entries and the output; 2 H (rank + rope + rank)
    operations a key (scores over [ckv; kr], context over ckv)."""
    nbytes = (b * h * (rank + rope) * elem + keys * (rank + rope) * elem + 4 * b
              + b * h * rank * elem)
    if pages is not None:
        nbytes += 4 * pages
    return Cost(nbytes, 2 * keys * h * (rank + rope + rank), _float(elem))


def mla_latent_decode(b, h, rank, rope, elem, keys) -> Cost:
    """Kernel 4, dense absorbed-MLA decode."""
    return _mla(b, h, rank, rope, elem, keys, None)


def mla_paged_latent_decode(b, h, rank, rope, elem, keys, pages) -> Cost:
    """Kernel 5, paged absorbed-MLA decode."""
    return _mla(b, h, rank, rope, elem, keys, pages)


def _ssd_ops(b, s, h, p, n) -> int:
    """Per token 2 Q N for c.b (shared by the heads), and per token and head
    (Q + 1) P for the causal intra-chunk term, 2 N P for the inter-chunk
    term and 2 N P for the state pass."""
    q = SCAN_CHUNK
    return b * s * (2 * q * n + h * ((q + 1) * p + 4 * n * p))


def _gdn_ops(b, s, h, k) -> int:
    """Per token and head 5 Q K + 6 K^2: the strictly lower half of K K^T
    and the lower half of Q K^T (Q K each), the two triangular solves for
    U~ = T V and W = T diag(g) K (2 Q K), the causal (Q K^T . Gamma) U
    (Q K), and the three products with the state, W S0, diag(g) Q S0 and
    the update (2 K^2 each)."""
    return b * s * h * (5 * SCAN_CHUNK * k + 6 * k * k)


def ssd_scan(b, s, h, p, n, elem) -> Cost:
    """Kernel 3: x, dt, a, b, c read, y and the fp32 final state written;
    bf16 inputs run the products on bf16 tensor cores, fp32 on the CUDA
    cores."""
    nbytes = 2 * b * s * h * p * elem + 4 * b * s * h + 4 * h + 2 * b * s * n * elem \
        + 4 * b * h * p * n
    return Cost(nbytes, _ssd_ops(b, s, h, p, n), _float(elem))


def gdn_scan(b, s, h, k, elem) -> Cost:
    """Kernel 6 (K = V): q, k, v, beta, alpha read, y and the fp32 final
    state written; over the tensor-core peak (TF32 for fp32 inputs)."""
    nbytes = 4 * b * s * h * k * elem + 8 * b * s * h + 4 * b * h * k * k
    return Cost(nbytes, _gdn_ops(b, s, h, k), "bfloat16" if elem == 2 else "tfloat32")


def ssd_scan_bwd(b, s, h, p, n, elem) -> Cost:
    """The SSD backward without dfinal: the forward's inputs and dy read,
    every gradient written; three times the forward's operations (the states
    are not among the inputs, so the forward is recomputed, and each of its
    products has two products as its backward)."""
    nbytes = 3 * b * s * h * p * elem + 4 * b * s * n * elem + 8 * b * s * h + 8 * h
    return Cost(nbytes, 3 * _ssd_ops(b, s, h, p, n), _float(elem))


def gdn_scan_bwd(b, s, h, k, elem) -> Cost:
    """The GDN backward without dfinal: as ``ssd_scan_bwd``."""
    nbytes = 7 * b * s * h * k * elem + 16 * b * s * h
    return Cost(nbytes, 3 * _gdn_ops(b, s, h, k), "bfloat16" if elem == 2 else "tfloat32")


def record(name: str, cost: Cost) -> None:
    """Add one call of kernel ``name`` and its ``cost`` to every counter on
    torch's dispatch-mode stack that takes kernel counts (an object with an
    ``add_kernel`` method, ``launch.cost.CostCounter``). With none active it
    does nothing."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        add = getattr(mode, "add_kernel", None)
        if add is not None:
            add(name, cost)


def meta_keys(b: int, extent: int, window: int = 0, bs: Optional[int] = None) -> tuple:
    """(keys, pages) of a decode call on meta tensors, which carry no
    ``valid_len``: every key below the extent is valid, as in a decode cell
    (a cache of ``seq_len`` with one new token), and under a ``window`` the
    last ``window`` of them are attended; a paged call reads the table
    entries from the window's first page to the last."""
    first = max(extent - window, 0) if window else 0
    pages = None if bs is None else b * (-(-extent // bs) - first // bs)
    return b * (extent - first), pages
