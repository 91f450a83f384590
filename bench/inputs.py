"""The inputs both sides receive, drawn from the run's seed.

Weights and VQ state are drawn on the run's device in a few large calls
(one normal draw for every weight and codeword, one integer draw for
every assignment table); the graph on the host (``graphgen``).  Each kind
of draw has a seed of its own, derived from the run's seed and a tag, so
adding a draw of one kind never moves another's.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from bench import shapes as shp


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for draw ``tag`` of run ``seed``."""
    ss = np.random.SeedSequence([seed % (1 << 64), zlib.crc32(tag.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def model_state(cfg: dict, shapes: list[shp.LayerShape], n: int, seed: int,
                device) -> tuple[list[dict], list[dict]]:
    """(params, VQ states) in the published layouts: GCN ``w`` [f_in,
    f_out] and ``b``; GAT ``w`` [f_in, heads, f_out / heads], ``a_dst``,
    ``a_src`` [heads, f_out / heads] and ``b``.  A VQ state holds the
    whitened codewords [nb, k, f_blk] (0.02 x normal), EMA sizes (ones) and
    sums (the codewords), whitening moments (zeros, ones) and the
    assignment table [nb, n] int32 (uniform)."""
    m, k = cfg["model"], cfg["codebook"]["k"]
    gat = m["backbone"] == "gat"
    heads = m.get("heads", 1)
    sizes = []
    for sh in shapes:
        sizes.append(sh.f_in * sh.f_out)
        if gat:
            sizes += [sh.f_out, sh.f_out]
        sizes.append(sh.nb * k * sh.f_blk)
    flat = torch.randn(sum(sizes), generator=generator(seed, "normal", device),
                       device=device)
    tabs = torch.randint(0, k, (sum(sh.nb for sh in shapes) * n,),
                         generator=generator(seed, "tables", device),
                         device=device, dtype=torch.int32)
    parts = iter(torch.split(flat, sizes))
    params, states, t0 = [], [], 0
    for sh in shapes:
        w = next(parts).reshape(sh.f_in, sh.f_out) / float(np.sqrt(sh.f_in))
        p = {"w": w, "b": torch.zeros(sh.f_out, device=device)}
        if gat:
            fh = sh.f_out // heads
            p["w"] = w.reshape(sh.f_in, heads, fh)
            p["a_dst"] = 0.1 * next(parts).reshape(heads, fh)
            p["a_src"] = 0.1 * next(parts).reshape(heads, fh)
            p = {key: p[key] for key in ("w", "a_dst", "a_src", "b")}
        cw = 0.02 * next(parts).reshape(sh.nb, k, sh.f_blk)
        table = tabs[t0:t0 + sh.nb * n].reshape(sh.nb, n)
        t0 += sh.nb * n
        states.append({
            "codewords_w": cw, "cluster_size": torch.ones(sh.nb, k,
                                                          device=device),
            "cluster_sum": cw.clone(),
            "mean": torch.zeros(sh.nb, sh.f_blk, device=device),
            "var": torch.ones(sh.nb, sh.f_blk, device=device),
            "table": table})
        params.append(p)
    return params, states


def epoch_ids(perm: torch.Tensor, batch: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """A node permutation as whole batches: [S, b] ids (the tail batch
    wrap-padded from the permutation's start) and the [S, b] slot mask
    (0 on the padding)."""
    n = perm.shape[0]
    s = -(-n // batch)
    ids = torch.cat([perm, perm[:s * batch - n]])
    mask = (torch.arange(s * batch, device=perm.device) < n).float()
    return ids.reshape(s, batch).to(torch.int32), mask.reshape(s, batch)
