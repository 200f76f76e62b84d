"""Copy of hipstr_tpu/align/debruijn.py.

De Bruijn assembly of STR-flanking sequences.

Capability parity with the reference DebruijnGraph/DirectedGraph (reference:
src/debruijn_graph.{h,cpp}, src/directed_graph.{h,cpp}): k-mer graph seeded
with the reference path at weight 2, per-read strings at weight 1, pruning of
low-frequency non-reference edges, acyclicity/source/sink checks with
1bp-mismatch alternate kmers, and best-first (bottleneck-weight) path
enumeration.
"""

from __future__ import annotations

import functools
import heapq
import itertools
import math
from typing import Dict, List, Set, Tuple

MIN_KMER = 10
MAX_KMER = 15
MIN_PATH_WEIGHT = 2


class DebruijnGraph:
    def __init__(self, k: int, ref_seq: str):
        assert len(ref_seq) > k
        self.k = k
        self.ref_seq = ref_seq
        self.source_kmer = ref_seq[:k]
        self.sink_kmer = ref_seq[-k:]
        self.num_strings = 0
        # edge (u, v) -> weight ; node labels are kmers
        self.edges: Dict[Tuple[str, str], int] = {}
        self.ref_edges: Set[Tuple[str, str]] = set()
        self.out_edges: Dict[str, List[str]] = {}
        self.in_edges: Dict[str, List[str]] = {}
        self.add_string(ref_seq, weight=2)
        self.ref_edges = set(self.edges.keys())

    def _add_edge(self, u: str, v: str, weight: int) -> None:
        key = (u, v)
        if key in self.edges:
            self.edges[key] += weight
        else:
            self.edges[key] = weight
            self.out_edges.setdefault(u, []).append(v)
            self.in_edges.setdefault(v, []).append(u)
            self.out_edges.setdefault(v, [])
            self.in_edges.setdefault(u, [])

    def add_string(self, seq: str, weight: int = 1) -> None:
        if len(seq) <= self.k:
            return
        self.num_strings += 1
        prev = seq[:self.k]
        for i in range(1, len(seq) + 1 - self.k):
            nxt = seq[i:i + self.k]
            self._add_edge(prev, nxt, weight)
            prev = nxt

    def prune_edges(self, min_edge_freq: float, min_weight: int) -> None:
        """Drop non-reference edges below max(min_weight,
        ceil(min_edge_freq * num_strings)) (debruijn_graph.cpp:47-60)."""
        thresh = max(min_weight, int(math.ceil(min_edge_freq * self.num_strings)))
        doomed = [key for key, w in self.edges.items()
                  if key not in self.ref_edges and w < thresh]
        for (u, v) in doomed:
            del self.edges[(u, v)]
            self.out_edges[u].remove(v)
            self.in_edges[v].remove(u)

    def has_node(self, kmer: str) -> bool:
        return kmer in self.out_edges

    def has_cycles(self) -> bool:
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in self.out_edges}
        for start in self.out_edges:
            if color[start] != WHITE:
                continue
            stack = [(start, iter(self.out_edges[start]))]
            color[start] = GRAY
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    if color[nxt] == GRAY:
                        return True
                    if color[nxt] == WHITE:
                        color[nxt] = GRAY
                        stack.append((nxt, iter(self.out_edges[nxt])))
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    stack.pop()
        return False

    def is_source_ok(self) -> bool:
        s = self.source_kmer
        return (len(self.out_edges.get(s, [])) > 0
                and len(self.in_edges.get(s, [])) == 0)

    def is_sink_ok(self) -> bool:
        s = self.sink_kmer
        return (len(self.in_edges.get(s, [])) > 0
                and len(self.out_edges.get(s, [])) == 0)

    def _alt_kmer_nodes(self, kmer: str, source: bool, sink: bool) -> List[str]:
        """1bp-mismatch kmers present in the graph meeting source/sink rules
        (debruijn_graph.cpp:146-169)."""
        out = []
        for i in range(len(kmer)):
            for b in "ACGT":
                if b == kmer[i]:
                    continue
                alt = kmer[:i] + b + kmer[i + 1:]
                if self.has_node(alt):
                    if source and len(self.in_edges.get(alt, [])) > 0:
                        continue
                    if sink and len(self.out_edges.get(alt, [])) > 0:
                        continue
                    out.append(alt)
        return out

    def enumerate_paths(self, min_weight: int, max_paths: int
                        ) -> List[Tuple[str, int]]:
        """Best-first enumeration by bottleneck (min-edge) weight
        (debruijn_graph.cpp:171-216).  Requires an acyclic graph."""
        paths: List[Tuple[str, int]] = []
        counter = itertools.count()
        BIG = 1000000
        # heap entries: (-min_weight, tiebreak, node, path_prefix, min_weight)
        heap = []

        def push(node, prefix, minw):
            heapq.heappush(heap, (-minw, next(counter), node, prefix, minw))

        push(self.source_kmer, self.source_kmer, BIG)
        for alt in self._alt_kmer_nodes(self.source_kmer, True, False):
            push(alt, alt, BIG)

        sink_set = {self.sink_kmer}
        sink_set.update(self._alt_kmer_nodes(self.sink_kmer, False, True))

        while heap:
            if len(paths) == max_paths:
                break
            _, _, node, prefix, minw = heapq.heappop(heap)
            if node in sink_set:
                paths.append((prefix, minw))
            for nxt in self.out_edges.get(node, []):
                w = self.edges[(node, nxt)]
                if w < min_weight:
                    continue
                push(nxt, prefix + nxt[-1], min(minw, w))
        return paths

    @staticmethod
    def calc_kmer_length(ref_seq: str, min_kmer: int, max_kmer: int):
        """Smallest k in [min_kmer, max_kmer] whose reference-path graph is
        acyclic; None if none (debruijn_graph.cpp:22-30).

        A graph built from a single string's k-mer walk is acyclic exactly
        when no k-mer repeats (a repeat closes the walk back onto an
        already-visited node), so the guard reduces to a distinctness
        check — no graph construction or DFS.  Memoized: the driver probes
        the same two flank sequences once in genotype_prepare and again in
        flank assembly."""
        return _calc_kmer_length_cached(ref_seq, min_kmer, max_kmer)


@functools.lru_cache(maxsize=4096)
def _calc_kmer_length_cached(ref_seq: str, min_kmer: int, max_kmer: int):
    n = len(ref_seq)
    for k in range(min_kmer, max_kmer + 1):
        if n <= k:
            return None
        n_kmers = n - k + 1
        if len({ref_seq[i:i + k] for i in range(n_kmers)}) == n_kmers:
            return k
    return None
