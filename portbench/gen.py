"""Device-side inputs made from the seed in a few large calls: brown-noise
clips at the processing rate and a library of random packed fingerprints."""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, key: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + key) % (1 << 63))
    return g


def brown_noise(seed: int, key: int, batch: int, n: int, device) -> torch.Tensor:
    """``[batch, n]`` float32 brown noise on ``device`` (the walk summed in
    float64)."""
    g = generator(seed, key, device)
    x = torch.randn((batch, n), generator=g, device=device, dtype=torch.float32) * 0.1
    return (torch.cumsum(x, dim=1, dtype=torch.float64) * 0.05).float()


def prefix_mask_words(n_bits: int, w: int) -> np.ndarray:
    """``[w]`` int32 words with the first ``n_bits`` bits set."""
    out = np.array([(1 << min(max(n_bits - 32 * k, 0), 32)) - 1 for k in range(w)], np.uint64)
    return out.astype(np.uint32).view(np.int32)


def random_words(seed: int, key: int, device, n: int, s: int, pairs: int,
                 min_count: int, max_count: int):
    """``[n, s, W]`` int32 (pos, neg) words and ``[n]`` int32 counts in
    ``[min_count, max_count]``: signs at random, about 3 % of pairs zero,
    pos and neg disjoint, bits past ``pairs`` and rows past a count zero."""
    g = generator(seed, key, device)
    w = -(-pairs // 32)

    def rand():
        return torch.randint(0, 256, (n, s, 4 * w), dtype=torch.uint8, generator=g,
                             device=device).view(torch.int32)

    counts = torch.randint(min_count, max_count + 1, (n,), dtype=torch.int32, generator=g,
                           device=device)
    sign = rand()
    nz = ~(rand() & rand() & rand() & rand() & rand())
    bits = torch.from_numpy(prefix_mask_words(pairs, w)).to(device)
    past = (torch.arange(s, device=device) >= counts[:, None])[..., None]
    pos = (sign & nz & bits).masked_fill_(past, 0)
    neg = (~sign & nz & bits).masked_fill_(past, 0)
    return pos, neg, counts


def library(seed: int, config: dict, device):
    """The configuration's library of random entries, on ``device``."""
    lib = config["library"]
    pairs = config["geometry"]["subfingerprint_length"] // 2
    return random_words(seed, 21, device, lib["tracks"], lib["rows"], pairs,
                        lib["min_count"], lib["max_count"])
