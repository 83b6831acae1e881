"""The traffic: blocks of token rows drawn from the seed.

One general generator serves every cell: block ``i`` of a run holds
``rows`` rows of ``cols`` token ids, uniform over the configuration's
vocabulary, from a generator keyed by (seed, i).  The same (seed, i)
gives the same block in any process, so the reference draws the blocks
again instead of taking them from the program.  A cell's traffic file
says how many rows and tokens a block has and how the driver feeds them.
"""

from __future__ import annotations

import functools

import numpy as np


def token_block(seed: int, index: int, rows: int, cols: int,
                vocab: int) -> np.ndarray:
    """(rows, cols) int64 token ids of block ``index``."""
    rng = np.random.default_rng([seed % 2 ** 64, index])
    return rng.integers(0, vocab, size=(rows, cols), dtype=np.int64)


def read_block(seed: int, index: int, rows: int, cols: int, vocab: int):
    """A read task's block: the tokens and, on every row, the block's
    index."""
    return {"tokens": token_block(seed, index, rows, cols, vocab),
            "block": np.full(rows, index, dtype=np.int64)}


def read_fns(seed: int, blocks: int, rows: int, cols: int, vocab: int):
    """One read function a block, for ``Dataset.from_read_fns``."""
    return [functools.partial(read_block, seed, i, rows, cols, vocab)
            for i in range(blocks)]
