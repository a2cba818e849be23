"""Topology managers for decentralized FL (port of
``fedml_tpu/partition/topology.py``, numpy only): weighted digraphs of
workers. Watts-Strogatz(k, β=0) ring lattices merged with a base ring,
self-loops on the diagonal, rows normalized to a mixing matrix; decentralized
gossip is ``params ← W @ stacked_params`` over the worker axis."""

from __future__ import annotations

import abc
from typing import List

import numpy as np


def _ws_adjacency(n: int, k: int) -> np.ndarray:
    """Watts-Strogatz(β=0) ring-lattice adjacency without networkx: node i
    connects to the k//2 nearest neighbors on each side (matches
    nx.watts_strogatz_graph(n, k, 0))."""
    a = np.zeros((n, n), np.float32)
    half = max(1, k // 2)
    for d in range(1, half + 1):
        for i in range(n):
            a[i, (i + d) % n] = 1.0
            a[i, (i - d) % n] = 1.0
    return a


class BaseTopologyManager(abc.ABC):
    topology: np.ndarray

    @abc.abstractmethod
    def generate_topology(self) -> None: ...

    def get_in_neighbor_weights(self, node_index: int):
        return self.topology[:, node_index]

    def get_out_neighbor_weights(self, node_index: int):
        return self.topology[node_index]

    def get_in_neighbor_idx_list(self, node_index: int) -> List[int]:
        return [
            j
            for j, w in enumerate(self.topology[:, node_index])
            if w > 0 and j != node_index
        ]

    def get_out_neighbor_idx_list(self, node_index: int) -> List[int]:
        return [
            j
            for j, w in enumerate(self.topology[node_index])
            if w > 0 and j != node_index
        ]


class SymmetricTopologyManager(BaseTopologyManager):
    """Ring ∪ WS(neighbor_num) with self-loops, row-normalized
    (ref symmetric_topology_manager.py:21-53). Symmetric ⇒ doubly-stochastic
    mixing when degrees are equal."""

    def __init__(self, n: int, neighbor_num: int = 2):
        self.n = n
        self.neighbor_num = neighbor_num
        self.topology = np.zeros((n, n), np.float32)

    def generate_topology(self) -> None:
        t = np.maximum(
            _ws_adjacency(self.n, 2), _ws_adjacency(self.n, self.neighbor_num)
        )
        np.fill_diagonal(t, 1.0)
        self.topology = t / t.sum(axis=1, keepdims=True)


class AsymmetricTopologyManager(BaseTopologyManager):
    """Symmetric base plus randomly added directed links, row-normalized
    (ref asymmetric_topology_manager.py:24-70; the reference's np.random
    link flips are reproduced with a seeded Generator)."""

    def __init__(self, n: int, undirected_neighbor_num: int = 3, out_directed_neighbor: int = 3, seed: int = 0):
        self.n = n
        self.undirected_neighbor_num = undirected_neighbor_num
        self.out_directed_neighbor = out_directed_neighbor
        self.seed = seed
        self.topology = np.zeros((n, n), np.float32)

    def generate_topology(self) -> None:
        rng = np.random.default_rng(self.seed)
        t = np.maximum(
            _ws_adjacency(self.n, 2),
            _ws_adjacency(self.n, self.undirected_neighbor_num),
        )
        np.fill_diagonal(t, 1.0)
        out_links = set()
        for i in range(self.n):
            zeros = [j for j in range(self.n) if t[i, j] == 0]
            flips = rng.integers(0, 2, size=len(zeros))
            for j, f in zip(zeros, flips):
                if f == 1 and (j * self.n + i) not in out_links:
                    t[i, j] = 1.0
                    out_links.add(i * self.n + j)
        self.topology = t / t.sum(axis=1, keepdims=True)
