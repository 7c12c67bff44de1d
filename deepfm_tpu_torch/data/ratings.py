"""Interaction triples for the two-tower family, copied from
``deepfm_tpu/data/ratings.py`` (the same files accepted, the same rows
skipped, the same batch order for a seed): ``parse_ratings_line``,
``load_ratings`` and ``RatingsDataset``.

``user item [rating] [timestamp]`` lines, the separator detected among
"::" (MovieLens .dat), comma (.csv, a header line skipped) and
whitespace, become id arrays; ``RatingsDataset.batches`` serves them as
two-tower batches (one field a side, vals 1.0), each epoch shuffled by
``np.random.default_rng(seed + epoch)``, the remainder dropped by
default.  The retrieval tasks read them (train/loop.py).
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Iterator

import numpy as np


def parse_ratings_line(line: str) -> tuple[int, int, float] | None:
    """``(user, item, rating)`` from one line, or None for blanks/headers."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    if "::" in line:
        parts = line.split("::")
    elif "," in line:
        parts = line.split(",")
    else:
        parts = line.split()
    if len(parts) < 2:
        return None
    try:
        user = int(parts[0])
        item = int(parts[1])
        # trailing separator leaves an empty parts[2]; treat as implicit 1.0
        rating = float(parts[2]) if len(parts) > 2 and parts[2].strip() else 1.0
    except ValueError:
        return None  # header row like "userId,movieId,rating", or junk rating
    return user, item, rating


def load_ratings(
    path_or_dir: str | os.PathLike,
    *,
    min_rating: float | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(user_ids i64 [N], item_ids i64 [N]) from a ratings file or directory.

    Directories are scanned for ratings*/train*/interactions* text files
    (.csv/.tsv/.dat/.txt).  ``min_rating`` keeps only interactions at or
    above the threshold (implicit-feedback binarization).
    """
    if os.path.isdir(path_or_dir):
        files: list[str] = []
        for pat in ("ratings*", "train*", "interactions*"):
            for ext in (".csv", ".tsv", ".dat", ".txt"):
                files.extend(
                    globlib.glob(os.path.join(path_or_dir, "**", pat + ext),
                                 recursive=True)
                )
        files = sorted(set(files))
        if not files:
            raise FileNotFoundError(
                f"no ratings*/train*/interactions* .csv/.tsv/.dat/.txt under "
                f"{path_or_dir!r}"
            )
    else:
        files = [str(path_or_dir)]
    users, items = [], []
    for f in files:
        with open(f) as fh:
            for line in fh:
                parsed = parse_ratings_line(line)
                if parsed is None:
                    continue
                u, i, r = parsed
                if min_rating is not None and r < min_rating:
                    continue
                users.append(u)
                items.append(i)
    return np.asarray(users, np.int64), np.asarray(items, np.int64)


class RatingsDataset:
    """In-memory interaction set serving two-tower batches.

    Single-field towers (user id, item id); vals are 1.0 — the pure-id
    MovieLens configuration.  Multi-field feature towers feed batches
    directly instead of using this convenience class.
    """

    def __init__(self, user_ids: np.ndarray, item_ids: np.ndarray):
        if user_ids.shape != item_ids.shape:
            raise ValueError("user/item id arrays must align")
        self.user_ids = user_ids
        self.item_ids = item_ids

    @classmethod
    def from_path(cls, path: str | os.PathLike, *, min_rating: float | None = None):
        return cls(*load_ratings(path, min_rating=min_rating))

    def __len__(self) -> int:
        return self.user_ids.shape[0]

    def max_ids(self) -> tuple[int, int]:
        """(max user id, max item id) — for vocab-size validation."""
        if len(self) == 0:
            return -1, -1
        return int(self.user_ids.max()), int(self.item_ids.max())

    def min_ids(self) -> tuple[int, int]:
        """(min user id, min item id) — negative ids are data corruption."""
        if len(self) == 0:
            return 0, 0
        return int(self.user_ids.min()), int(self.item_ids.min())

    def batches(
        self,
        batch_size: int,
        *,
        num_epochs: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
    ) -> Iterator[dict]:
        n = len(self)
        for epoch in range(num_epochs):
            order = np.arange(n)
            if shuffle:
                np.random.default_rng(seed + epoch).shuffle(order)
            end = n - (n % batch_size) if drop_remainder else n
            for lo in range(0, end, batch_size):
                idx = order[lo : lo + batch_size]
                b = idx.shape[0]
                yield {
                    "user_ids": self.user_ids[idx][:, None],
                    "user_vals": np.ones((b, 1), np.float32),
                    "item_ids": self.item_ids[idx][:, None],
                    "item_vals": np.ones((b, 1), np.float32),
                }
