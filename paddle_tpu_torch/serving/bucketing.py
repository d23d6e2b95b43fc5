"""Shape bucketing for the serving hot path (a copy of
paddle_tpu/serving/bucketing.py, which the port may not import).

paddle_tpu compiles one XLA executable per concrete input signature; the
port keeps the same finite signature set, so that each one can later be
captured once as a CUDA graph. An open-ended request mix (any batch size
x any sequence length) would otherwise grow without bound. Buckets make
the signature set finite: the micro-batcher rounds the
coalesced batch up to the nearest batch bucket and (optionally) each
request's leading example axis up to the nearest sequence bucket, padding
with a constant. Powers of two keep the bucket count logarithmic in the
largest shape while capping pad waste at <2x.

Correctness contract: padding the batch axis adds independent rows (sliced
off before results are returned), and right-padding the sequence axis of a
causal model leaves the real positions' outputs unchanged (position i
attends only to j <= i).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BucketOverflow", "pow2_buckets", "page_buckets", "next_bucket",
           "next_bucket_strict", "pad_axis", "bucket_example",
           "stack_and_pad"]


class BucketOverflow(ValueError):
    """A value exceeds every admissible bucket. Raised instead of
    propagating a silent ``None`` out of ``next_bucket``: every caller
    that cannot serve an over-max shape must fail loudly at admission
    time, not with an index error (or a new step signature) later.
    Subclasses ValueError so pre-existing callers catching the old
    ``bucket_example`` ValueError keep working."""


def pow2_buckets(max_value: int, min_value: int = 1) -> List[int]:
    """Powers of two up to ``max_value``; ``max_value`` itself is always a
    bucket (even when not a power of two) so the largest admissible shape
    has a home."""
    if max_value < 1:
        raise ValueError(f"max_value must be >= 1, got {max_value}")
    buckets, v = set(), max(1, int(min_value))
    while v < max_value:
        buckets.add(v)
        v *= 2
    buckets.add(int(max_value))
    return sorted(buckets)


def page_buckets(max_pages: int, min_pages: int = 1) -> List[int]:
    """Admissible KV-page-table widths for the decode engine: powers of
    two up to ``max_pages`` (``max_pages`` always included). One decode
    step signature exists per (batch bucket, page bucket) pair, so this set
    bounds the gathered-attention shapes exactly the way ``pow2_buckets``
    bounds the batch axis."""
    return pow2_buckets(max_pages, min_pages)


def next_bucket(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= n, or None when n exceeds every bucket."""
    best = None
    for b in buckets:
        if b >= n and (best is None or b < best):
            best = b
    return best


def next_bucket_strict(n: int, buckets: Sequence[int],
                       what: str = "value") -> int:
    """``next_bucket`` that raises ``BucketOverflow`` instead of
    returning None — the uniform over-max handling for every hot-path
    caller (silent None propagation turned into a TypeError two frames
    later in the old serving code)."""
    b = next_bucket(n, buckets)
    if b is None:
        raise BucketOverflow(
            f"{what} {n} exceeds the largest bucket {max(buckets)} "
            f"(buckets: {list(buckets)})")
    return b


def pad_axis(arr: np.ndarray, axis: int, target: int,
             value=0) -> np.ndarray:
    """Right-pad ``arr`` along ``axis`` to length ``target`` with
    ``value`` (no-op when already that length)."""
    if arr.shape[axis] == target:
        return arr
    if arr.shape[axis] > target:
        raise ValueError(
            f"cannot pad axis {axis} of {arr.shape} down to {target}")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - arr.shape[axis])
    return np.pad(arr, widths, constant_values=value)


def bucket_example(arr: np.ndarray, seq_buckets: Optional[Sequence[int]]
                   ) -> Tuple[int, ...]:
    """The bucketed shape of ONE example: axis 0 (the variable/sequence
    axis) rounds up to its bucket; other axes stay exact. With no
    ``seq_buckets``, the exact shape is the bucket (requests group by
    identical shapes only)."""
    shape = list(arr.shape)
    if seq_buckets and arr.ndim >= 1:
        shape[0] = next_bucket_strict(shape[0], seq_buckets,
                                      "example axis-0 length")
    return tuple(shape)


def stack_and_pad(rows: List[np.ndarray], example_shape: Tuple[int, ...],
                  batch_target: int, value=0) -> Tuple[np.ndarray, int]:
    """Stack per-request examples (each right-padded on axis 0 to
    ``example_shape``) into a ``[batch_target, *example_shape]`` array,
    padding missing batch rows with ``value``. Returns (batch, real_elems)
    where real_elems counts the unpadded payload for pad-waste
    accounting."""
    real = 0
    padded = []
    for r in rows:
        real += int(np.prod(r.shape, dtype=np.int64)) if r.ndim else 1
        if tuple(r.shape) != example_shape:
            r = pad_axis(r, 0, example_shape[0], value)
        padded.append(r)
    out = np.zeros((batch_target,) + example_shape, dtype=rows[0].dtype)
    if value != 0:
        out[...] = value
    if padded:
        out[:len(padded)] = np.stack(padded)
    return out, real
