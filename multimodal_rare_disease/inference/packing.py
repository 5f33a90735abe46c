"""Sequence packing for batched text inference.

The serving corpus tokenizes far short of the 128-token bucket
(clinical descriptions: 75-95 WordPiece tokens), so a batch of N
documents padded to T=128 spends ~30% of the BERT tower's linear
compute (FFN/QKV/projections — the dominant cost) on pad positions.
Packing 2-3 documents per row at capacity 256 cuts effective
tokens/document from 128 to ~90 while keeping every shape lane-aligned.

Numerics match the unpacked forward up to f32 summation order:

- a block-diagonal additive mask (built from `segment_ids` in
  models/bert.py) puts -1e9 on every cross-document score; after the
  f32 softmax's exp(s - max) that contribution underflows to exactly
  0.0 — masked positions contribute NOTHING;
- `position_ids` restart at each document start, so position
  embeddings match the unpacked forward exactly;
- every other op (embeddings, LN, FFN, projections) is per-position;
- the only residual difference is reduction-tree shape: a 256-long
  key axis partitions the live terms into different partial sums than
  a 128-long one (measured ~2e-7 on CPU f32, the same noise as
  changing the padding bucket; tests/test_packing.py pins atol 1e-5).

The reference has no analogue (its predict path pads every request to
a fixed 128 tokens and runs unbatched — `src/predict.py:111-118`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class PackedBatch:
    """Device-ready arrays describing N documents packed into R rows of
    `capacity` tokens. `doc_row[i]`/`doc_slot[i]` locate document i's
    output in the encoder's [R, P, H] per-document embeddings."""

    input_ids: np.ndarray       # [R, capacity] int32
    position_ids: np.ndarray    # [R, capacity] int32 (restart per doc)
    segment_ids: np.ndarray     # [R, capacity] int32 (0 pad, 1.. = doc)
    query_positions: np.ndarray  # [R, P] int32 (doc start offsets)
    doc_row: np.ndarray         # [N] int32
    doc_slot: np.ndarray        # [N] int32
    capacity: int

    @property
    def num_rows(self) -> int:
        return self.input_ids.shape[0]

    @property
    def tokens_per_doc(self) -> float:
        return self.input_ids.size / len(self.doc_row)


def pack_texts(ids: np.ndarray, mask: np.ndarray, capacity: int = 256,
               row_multiple: int = 8) -> PackedBatch:
    """First-fit-decreasing bin packing of N tokenized documents.

    ids/mask: [N, T] (right-padded). capacity must be a multiple of 128
    (aligned shapes; kept from the first design) and >= the longest
    document. Rows are padded up to a
    multiple of `row_multiple` with empty rows.
    """
    n, t = ids.shape
    lens = mask.astype(bool).sum(axis=1).astype(int)
    if capacity % 128 != 0:
        raise ValueError(f"capacity {capacity} must be a multiple of 128")
    if lens.max(initial=0) > capacity:
        raise ValueError(f"document of {lens.max()} tokens exceeds "
                         f"capacity {capacity}")

    order = np.argsort(-lens, kind="stable")
    rows: list[list[int]] = []     # doc indices per row
    row_used = []
    for i in order:
        li = int(lens[i])
        for r, used in enumerate(row_used):
            if used + li <= capacity:
                rows[r].append(int(i))
                row_used[r] += li
                break
        else:
            rows.append([int(i)])
            row_used.append(li)

    R = -(-len(rows) // row_multiple) * row_multiple
    P = max(len(r) for r in rows)
    out_ids = np.zeros((R, capacity), np.int32)
    pos = np.zeros((R, capacity), np.int32)
    seg = np.zeros((R, capacity), np.int32)
    qpos = np.zeros((R, P), np.int32)
    doc_row = np.zeros(n, np.int32)
    doc_slot = np.zeros(n, np.int32)
    for r, docs in enumerate(rows):
        off = 0
        for slot, i in enumerate(docs):
            li = int(lens[i])
            out_ids[r, off:off + li] = ids[i, :li]
            pos[r, off:off + li] = np.arange(li)
            seg[r, off:off + li] = slot + 1
            qpos[r, slot] = off
            doc_row[i] = r
            doc_slot[i] = slot
            off += li
    return PackedBatch(out_ids, pos, seg, qpos, doc_row, doc_slot,
                       capacity)


def packing_wins(lens: Sequence[int], bucket: int,
                 capacity: int = 256) -> bool:
    """Decide whether packing beats the classic per-doc bucket: compare
    total token rows. The quadratic attention term grows with capacity,
    so require ~15% fewer tokens before switching."""
    lens = np.asarray(lens)
    sim = pack_texts(np.zeros((len(lens), int(lens.max())), np.int32),
                     (np.arange(int(lens.max()))[None, :]
                      < lens[:, None]).astype(np.int32),
                     capacity)
    packed_tokens = sim.num_rows * capacity
    return packed_tokens < 0.85 * len(lens) * bucket
