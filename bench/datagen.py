"""The data of a deployment, drawn on the device from ``--seed``.

Plain PyTorch. The set-up hands these tensors to the program, and the
reference draws them again after the window, so both sides see the same
bits and values and the reference takes nothing the program made. Every
draw goes through a ``torch.Generator`` on the data's device, in a fixed
order and in chunks of a fixed size, so a seed gives the same data on
every run (on the card; the CPU's stream differs, which only the CPU
tests see).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

CHUNK_ROWS = 1 << 27    # rows drawn at once (multiple of 32)
WORD = 32


def torch_seed(seed: int, *salt: int) -> int:
    """A 63-bit generator seed for stream ``salt`` of ``seed``."""
    ss = np.random.SeedSequence([seed % (1 << 64), *salt])
    return int(ss.generate_state(1, np.uint64)[0] & ((1 << 63) - 1))


def generator(device, seed: int, *salt: int) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(torch_seed(seed, *salt))
    return g


def words_for(n_bits: int) -> int:
    return (n_bits + WORD - 1) // WORD


def bitmap_names(cfg: dict) -> List[str]:
    """The config's bitmaps in draw order (``{"name": "week{i}",
    "count": 52}`` expands to week0..week51)."""
    names = []
    for b in cfg["bitmaps"]:
        if "count" in b:
            names += [b["name"].format(i=i) for i in range(int(b["count"]))]
        else:
            names.append(b["name"])
    return names


def bitmap_words(cfg: dict, seed: int, device) -> torch.Tensor:
    """Every bitmap of the config as packed int32 words, one row each,
    in one draw: each bit is set with probability 0.5 (uniform words);
    bits past ``n_users`` are zero."""
    if float(cfg["density"]) != 0.5:
        raise ValueError("bitmaps are drawn as uniform words: density 0.5")
    n_users = int(cfg["n_users"])
    rows, words = len(bitmap_names(cfg)), words_for(n_users)
    g = generator(device, seed, 101)
    data = torch.randint(-(1 << 31), 1 << 31, (rows, words),
                         dtype=torch.int32, device=device, generator=g)
    rem = n_users % WORD
    if rem:
        data[:, -1] &= (1 << rem) - 1
    return data


def column_chunks(cfg: dict, seed: int, device
                  ) -> Iterator[Tuple[int, int, Dict[str, torch.Tensor]]]:
    """The columns' values, ``CHUNK_ROWS`` rows at a time: yields
    ``(first_row, rows, {column: int64 values})``. A column's value is
    the sum of independent uniform draws, one per ``[lo, hi]`` range of
    its ``uniform_sum`` (both ends included)."""
    n_rows = int(cfg["n_rows"])
    gens = {c["name"]: generator(device, seed, 201, k)
            for k, c in enumerate(cfg["columns"])}
    for row0 in range(0, n_rows, CHUNK_ROWS):
        rows = min(CHUNK_ROWS, n_rows - row0)
        out = {}
        for c in cfg["columns"]:
            v = None
            for lo, hi in c["uniform_sum"]:
                d = torch.randint(int(lo), int(hi) + 1, (rows,),
                                  dtype=torch.int64, device=device,
                                  generator=gens[c["name"]])
                v = d if v is None else v.add_(d)
            out[c["name"]] = v
        yield row0, rows, out
