"""The generator of vector traffic: a base resident on the device and, for
each call, a fresh query batch, all unit vectors made on the device from
the run's seed.

A mix's parameters:
  common_cos   cosine that any two unrelated vectors share through one
               common direction (0: none, isotropic Gaussian rows);
  cluster_cos  cosine of two vectors of one cluster (with clusters > 0);
  clusters     number of clusters; their sizes in the base follow
               Zipf(`zipf`) by rank, the same sizes for every seed, and
               each query draws its cluster from the same law.
A vector is a u + b c + s n, normalized, with u the common direction, c
its cluster's centre and n noise, a^2 = common_cos,
b^2 = cluster_cos - common_cos, s^2 = 1 - cluster_cos (1 - common_cos
without clusters).
"""

import math

import torch

from nwbench import seeds

CHUNK_ROWS = 131072


def _unit(x):
    return x / x.norm(dim=1, keepdim=True)


def zipf_sizes(n: int, groups: int, s: float) -> list:
    """`n` items over `groups` by Zipf(s) weights, largest remainders
    rounded up."""
    w = [1.0 / (r + 1) ** s for r in range(groups)]
    total = sum(w)
    exact = [n * x / total for x in w]
    sizes = [math.floor(e) for e in exact]
    order = sorted(range(groups), key=lambda r: sizes[r] - exact[r])
    for r in order[: n - sum(sizes)]:
        sizes[r] += 1
    return sizes


class VectorTraffic:
    def __init__(self, mix: dict, n_base: int, n_query: int, dim: int,
                 seed: int, device):
        self.mix = mix
        self.n_base, self.n_query, self.dim = n_base, n_query, dim
        self.seed = seed
        self.device = torch.device(device)
        self.common = float(mix.get("common_cos", 0.0))
        self.clusters = int(mix.get("clusters", 0))
        inner = float(mix["cluster_cos"]) if self.clusters else self.common
        self.a = math.sqrt(self.common)
        self.b = math.sqrt(inner - self.common)
        self.s = math.sqrt(1.0 - inner)
        g = seeds.torch_gen(self.device, seed, seeds.BASE)
        self.u = _unit(torch.randn(1, dim, generator=g, device=self.device))
        if self.clusters:
            self.centres = _unit(torch.randn(self.clusters, dim, generator=g,
                                             device=self.device))
            sizes = zipf_sizes(n_base, self.clusters, float(mix["zipf"]))
            self.weights = torch.tensor(sizes, dtype=torch.float32,
                                        device=self.device)
            labels = torch.repeat_interleave(
                torch.arange(self.clusters, device=self.device),
                self.weights.long())
            perm = torch.randperm(n_base, generator=g, device=self.device)
            self.base_labels = labels[perm]
        self._base_gen = g

    def _rows(self, n: int, labels, g):
        x = torch.randn(n, self.dim, generator=g, device=self.device)
        x.mul_(self.s / math.sqrt(self.dim))
        if self.a:
            x.add_(self.u, alpha=self.a)
        if labels is not None:
            x.add_(self.centres[labels], alpha=self.b)
        return _unit(x)

    def base(self):
        """(n_base, dim) float32 unit rows."""
        out = torch.empty(self.n_base, self.dim, device=self.device)
        for s in range(0, self.n_base, CHUNK_ROWS):
            n = min(CHUNK_ROWS, self.n_base - s)
            lab = self.base_labels[s:s + n] if self.clusters else None
            out[s:s + n] = self._rows(n, lab, self._base_gen)
        return out

    def queries(self, call: int, tag: int = seeds.QUERY):
        """(n_query, dim) float32 unit rows of call number `call`."""
        g = seeds.torch_gen(self.device, self.seed, tag, call)
        lab = None
        if self.clusters:
            lab = torch.multinomial(self.weights, self.n_query,
                                    replacement=True, generator=g)
        return self._rows(self.n_query, lab, g)


def make(mix: dict, seed: int, device, *, n_base: int, n_query: int,
         dim: int) -> VectorTraffic:
    return VectorTraffic(mix, n_base, n_query, dim, seed, device)
