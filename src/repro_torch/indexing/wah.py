"""WAH bitmap-index construction, fully data-parallel (paper §4).

Follows Fusco et al. ("Indexing Million of Packets Per Second Using
GPUs", IMC'13) as summarized in the paper: (1) encode values with input
position, (2) stable sort by value, (3) derive 31-bit chunk literals via
segmented OR, (4) derive zero-fill words from chunk gaps, (5)
``fuseFillsLiterals`` — interleave + stream-compact (paper Listing 5),
(6) build the per-value lookup table.

WAH word format (Wu et al.): literal = MSB 0 + 31 payload bits;
fill = MSB 1, bit 30 = fill bit, bits 0..29 = count of 31-bit groups.
Trailing zero-fills are implicit (decode pads to ``n``).

Everything runs on the device of the input tensor with fixed shapes and
the prefix-valid convention. The hot stages are the hand-written kernels
(radix pass, interleave, local compaction); the segment arithmetic
between them is plain PyTorch on int64, the words return as uint32. The
:func:`wah_index_pipeline_actors` variant wires the fuse step as a
composed pipeline of kernel actors exchanging ``DeviceRef``\\ s — the
exact shape of the paper's Listing 5.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import i64_to_u32, u32_to_i64

__all__ = ["build_wah_index", "build_wah_index_numpy", "decode_wah_bitmap",
           "wah_index_pipeline_actors"]

_FILL_FLAG = 1 << 31
_COUNT_MASK = (1 << 30) - 1


def build_wah_index(values: torch.Tensor, cardinality: int, *,
                    impl: str = "auto"):
    """Build a WAH bitmap index of ``values`` (uint32 < cardinality).

    Returns ``(index_words, n_words, starts, counts)``: the compacted word
    stream (uint32, prefix-valid), its logical length (0-d int32), and the
    per-value lookup table (int32). ``impl="ref"`` runs every kernel's
    plain version instead.
    """
    n = values.shape[0]
    dev = values.device
    if values.dtype != torch.uint32:
        values = i64_to_u32(values.to(torch.int64))
    pos = torch.arange(n, dtype=torch.int32, device=dev)

    # (1)+(2): encode with position, stable sort by value → positions stay
    # ascending within each value, hence chunk ids are ascending.
    v_sorted, pos_sorted = ops.radix_sort(values, pos, impl=impl)
    v_sorted = u32_to_i64(v_sorted)
    pos_sorted = pos_sorted.to(torch.int64)

    # (3): 31-bit chunk literals by segmented OR (distinct bits → sum).
    chunk = pos_sorted // 31
    bitword = torch.ones_like(pos_sorted) << (pos_sorted % 31)

    first = torch.ones(1, dtype=torch.bool, device=dev)
    new_v = torch.cat([first, v_sorted[1:] != v_sorted[:-1]])
    new_seg = new_v | torch.cat([first, chunk[1:] != chunk[:-1]])
    seg = torch.cumsum(new_seg.to(torch.int64), 0) - 1   # element → segment
    n_seg = seg[-1] + 1

    literals = torch.zeros(n, dtype=torch.int64, device=dev)
    literals.index_add_(0, seg, bitword)
    seg_valid = torch.arange(n, device=dev) < n_seg
    literals = torch.where(seg_valid, literals, 0)
    seg_v = torch.zeros(n, dtype=torch.int64, device=dev)
    seg_v.index_put_((seg,), v_sorted)
    seg_chunk = torch.zeros(n, dtype=torch.int64, device=dev)
    seg_chunk.index_put_((seg,), chunk)

    # (4): zero-fill words from gaps between consecutive chunks of a value.
    prev_chunk = torch.cat([seg_chunk.new_full((1,), -1), seg_chunk[:-1]])
    same_v = torch.cat([~first, seg_v[1:] == seg_v[:-1]])
    prev = torch.where(same_v, prev_chunk, -1)
    gap = seg_chunk - prev - 1
    fills = torch.where(seg_valid & (gap > 0), _FILL_FLAG | gap, 0)

    # (5): fuseFillsLiterals — interleave then compact (paper Listing 5).
    fused = ops.wah_interleave(i64_to_u32(fills), i64_to_u32(literals),
                               impl=impl)
    index_words, n_words = ops.stream_compact(fused, impl=impl)

    # (6): lookup table — words contributed per segment, summed per value.
    words_per_seg = torch.where(seg_valid, (gap > 0).to(torch.int64) + 1, 0)
    counts = torch.zeros(cardinality, dtype=torch.int64, device=dev)
    counts.index_add_(0, seg_v, words_per_seg)
    starts = torch.cumsum(counts, 0) - counts
    return (index_words, n_words, starts.to(torch.int32),
            counts.to(torch.int32))


def build_wah_index_numpy(values: np.ndarray, cardinality: int):
    """Sequential CPU reference (the paper Fig. 3 CPU baseline)."""
    words, starts, counts = [], np.zeros(cardinality, np.int64), np.zeros(
        cardinality, np.int64)
    for v in range(cardinality):
        starts[v] = len(words)
        positions = np.flatnonzero(values == v)
        cur_chunk, cur_word = None, 0
        for p in positions:
            c, b = divmod(int(p), 31)
            if c != cur_chunk:
                if cur_chunk is not None:
                    words.append(cur_word)
                gap = c if cur_chunk is None else c - cur_chunk - 1
                if gap > 0:
                    words.append((1 << 31) | gap)
                cur_chunk, cur_word = c, 0
            cur_word |= (1 << b)
        if cur_chunk is not None:
            words.append(cur_word)
        counts[v] = len(words) - starts[v]
    return np.asarray(words, np.uint32), len(words), starts, counts


def decode_wah_bitmap(index_words: np.ndarray, start: int, count: int) -> np.ndarray:
    """Decode one value's WAH word stream back to a position list."""
    positions = []
    chunk = 0
    for w in np.asarray(index_words[start:start + count], np.uint32):
        w = int(w)
        if w >> 31:
            if (w >> 30) & 1:
                raise ValueError("only zero-fills are emitted")
            chunk += w & _COUNT_MASK
        else:
            for b in range(31):
                if w & (1 << b):
                    positions.append(chunk * 31 + b)
            chunk += 1
    return np.asarray(positions, np.int64)


# ----------------------------------------------------------------------------
# Actor-pipeline variant (paper Listing 5): three kernel actors composed.
# ----------------------------------------------------------------------------
def wah_index_pipeline_actors(system, k: int, mode: str = "staged"):
    """Build the prepare → count → move pipeline for length-``k`` inputs.

    The returned pipeline ref accepts ``(fills, literals)`` (uint32, length
    k) and responds with ``(index_words, n_words)``. In ``staged`` mode
    (paper Listing 5) intermediates travel as ``DeviceRef``\\ s — data stays
    on the device between stages; ``fused`` runs the three kernels inside
    one actor. The actors run on the system's device (the first CUDA
    device unless the system was created with another).
    """
    from ..core import In, NDRange, Out, Pipeline, dim_vec, kernel
    from ..kernels.stream_compact import local_compact

    bs = 256
    if (2 * k) % bs:
        raise ValueError(f"2*k={2 * k} must be a multiple of {bs}")

    def prepare_index(fills, literals):
        return ops.wah_interleave(fills, literals)

    def count_elements(index):
        blocks, cnts = local_compact(index, bs=bs)
        return index, blocks, cnts

    def move_valid_elements(index, blocks, cnts):
        return ops.compact_gather(blocks, cnts, index.shape[0])

    rng = NDRange(dim_vec(k))
    rng_sc = NDRange(dim_vec(2 * k), local_dims=dim_vec(bs))
    prepare = kernel(In(torch.uint32), In(torch.uint32),
                     Out(torch.uint32, as_ref=True),
                     nd_range=rng, name="prepare_index")(prepare_index)
    count = kernel(In(torch.uint32),
                   Out(torch.uint32, as_ref=True),
                   Out(torch.uint32, as_ref=True),
                   Out(torch.int32, as_ref=True),
                   nd_range=rng_sc, name="count_elements")(count_elements)
    move = kernel(In(torch.uint32), In(torch.uint32), In(torch.int32),
                  Out(torch.uint32), Out(torch.int32),
                  nd_range=rng_sc, name="move_valid_elements")(
                      move_valid_elements)
    return (Pipeline(system, mode=mode, name="wah_index")
            .stage(prepare).stage(count).stage(move).build())
