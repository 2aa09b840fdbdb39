"""The benchmark's weights: drawn from the seed on the device, in a layout
of the benchmark's own, and handed unchanged to the program and to the
reference.

A leaf is one named weight of every layer that has it, stacked ``[layers,
...]`` (``blk.attn.wq`` of a dense decoder: ``[24, 1536, 1536]``; the
configuration's family gives each layer's shapes), or an
IO weight (``embed``, ``head``, ``final_ln``; a config whose inputs are
embeddings supplied by a frontend has an ``embed`` that nothing reads, as
the program does).  Each leaf is one draw from a
``torch.Generator`` of its own, seeded from the run's seed and the leaf's
index, in the dtype the configuration serves it in: a leaf can be drawn
again alone (the harness does so to measure how far the program moved it).
The paths are the program's module paths after ``slots.{i}.``, the names
the JAX package's stacked parameter tree uses as well.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from rrfp_bench.harness import manifest
from rrfp_bench.yardstick.flops import padded_vocab

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: str
    shape: tuple[int, ...]        # one layer's (or the IO weight's) shape
    dtype: torch.dtype
    std: float                    # 0: zeros (the norms' scales)
    layers: tuple[int, ...] | None  # global layers stacked; None: IO


def leaves(c: dict) -> list[Leaf]:
    """Every leaf of the model, stage leaves first, in a fixed order: the
    family's layers' leaves in the order they first appear, then the IO
    leaves."""
    fam = manifest.family(c)
    by_path: dict[str, list] = {}
    for g, kind in enumerate(fam.pattern(c)):
        for path, spec in fam.layer_leaves(c, kind).items():
            by_path.setdefault(path, [spec, []])[1].append(g)
    out = [Leaf(p, s[0], s[1], s[2], tuple(gs))
           for p, (s, gs) in by_path.items()]
    d, dt = c["d_model"], DTYPES[c["dtype"]]
    v = padded_vocab(c)
    out += [Leaf("embed", (v, d), dt, 0.02, None),
            Leaf("head", (v, d), dt, 1 / math.sqrt(d), None),
            Leaf("final_ln", (d,), dt, 0.0, None)]
    return out


def leaf_seed(seed: int, index: int) -> int:
    return (seed * 1_000_003 + 7_919 * (index + 1)) % (2 ** 63)


def draw(leaf: Leaf, index: int, seed: int, device) -> torch.Tensor:
    """Leaf ``index`` of the model drawn from ``seed``: the same tensor
    every time on one device."""
    shape = leaf.shape if leaf.layers is None else (len(leaf.layers),
                                                    *leaf.shape)
    if leaf.std == 0.0:
        return torch.zeros(shape, dtype=leaf.dtype, device=device)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(leaf_seed(seed, index))
    t = torch.randn(shape, generator=gen, dtype=leaf.dtype, device=device)
    return t.mul_(leaf.std)


def draw_all(c: dict, seed: int, device) -> dict[str, torch.Tensor]:
    return {leaf.path: draw(leaf, i, seed, device)
            for i, leaf in enumerate(leaves(c))}


def leaf_key(path: str, layer: int | None) -> str:
    """The name a comparison gives one layer's slice of a leaf."""
    return path if layer is None else f"{path}[{layer}]"
