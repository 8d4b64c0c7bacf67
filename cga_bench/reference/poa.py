"""Plain NumPy partial-order alignment consensus: the benchmark's reference
for the port's POA batches.

A frozen copy of the consensus path of the JAX package's CPU oracle
(``cpu/poa_oracle.py``), the POA spec every implementation is held to:

1. topological order: level-based Kahn, order by (level, node index);
2. graph-vs-sequence NW with linear gap, rows the nodes in that order, a
   virtual source row j * gap; a cell takes the best of the preds'
   diagonal and vertical moves and its own row's horizontal move;
3. the alignment ends at the best sink in the last column, ties to the
   smallest rank;
4. traceback: diagonal first (preds in ascending index), then vertical,
   then horizontal;
5. extension: a match reuses the node, a mismatch reuses an aligned node of
   the same base or makes one joined to the aligned clique, an insertion a
   new node; edge weights add min of the two bases' weights;
6. consensus: heaviest bundle, best pred by (edge weight, pred score,
   -pred), the path ending at the best (score, -rank).

Capacity limits give the statuses of the spec: a window past its node,
pred-slot or aligned-slot limit fails.  The one change from the copy: the
horizontal move of an unbanded row, row[j] = max(diag[j - 1],
row[j - 1] + gap), is taken as a running maximum of row[j] - j * gap,
which is the same integers.  ``control`` breaks the consensus tie rule
(the larger pred index wins a tie): the benchmark's control.
"""

import numpy as np

BASES = "ACGT"


class Overflow(Exception):
    pass


class Graph:
    def __init__(self, max_nodes, max_pred, max_aligned, match, mismatch,
                 gap):
        self.max_nodes, self.max_pred = max_nodes, max_pred
        self.max_aligned = max_aligned
        self.match, self.mismatch, self.gap = match, mismatch, gap
        self.base: list[int] = []
        self.preds: list[list[int]] = []
        self.pw: list[list[int]] = []
        self.succs: list[list[int]] = []
        self.aligned: list[list[int]] = []

    def new_node(self, b):
        if len(self.base) >= self.max_nodes:
            raise Overflow("nodes")
        self.base.append(int(b))
        self.preds.append([])
        self.pw.append([])
        self.succs.append([])
        self.aligned.append([])
        return len(self.base) - 1

    def add_edge(self, u, v, w):
        pl = self.preds[v]
        if u in pl:
            self.pw[v][pl.index(u)] += w
            return
        if len(pl) >= self.max_pred:
            raise Overflow("preds")
        pos = int(np.searchsorted(np.array(pl, np.int64), u)) if pl else 0
        pl.insert(pos, u)
        self.pw[v].insert(pos, w)
        sl = self.succs[u]
        spos = int(np.searchsorted(np.array(sl, np.int64), v)) if sl else 0
        sl.insert(spos, v)

    def link_aligned(self, new, to):
        group = [to] + list(self.aligned[to])
        if len(group) >= self.max_aligned + 1:
            raise Overflow("aligned")
        for g in group:
            self.aligned[g] = sorted(self.aligned[g] + [new])
        self.aligned[new] = sorted(group)

    def order(self):
        n = len(self.base)
        level = [0] * n
        indeg = [len(p) for p in self.preds]
        ready = [u for u in range(n) if indeg[u] == 0]
        seen = 0
        while ready:
            nxt = []
            for u in ready:
                seen += 1
                for v in self.succs[u]:
                    level[v] = max(level[v], level[u] + 1)
                    indeg[v] -= 1
                    if indeg[v] == 0:
                        nxt.append(v)
            ready = sorted(nxt)
        if seen != n:
            raise Overflow("loop")
        return sorted(range(n), key=lambda u: (level[u], u))

    def align(self, seq):
        order = self.order()
        rank = {u: r for r, u in enumerate(order)}
        L = len(seq)
        NEG = -(2**30)
        S = np.full((len(order) + 1, L + 1), NEG, np.int64)
        jg = np.arange(L + 1, dtype=np.int64) * self.gap
        S[0] = jg
        sarr = np.array(seq, np.int64)
        for r, u in enumerate(order):
            pr = [rank[p] + 1 for p in self.preds[u]] or [0]
            pmax = S[pr].max(0)
            sub = np.where((sarr == self.base[u]) & (sarr >= 0),
                           self.match, self.mismatch)
            dv = np.maximum(pmax[:-1] + sub, pmax[1:] + self.gap)
            x = np.empty(L + 1, np.int64)
            x[0] = pmax[0] + self.gap
            x[1:] = dv - jg[1:]
            S[r + 1] = np.maximum.accumulate(x) + jg
        sinks = [r for r, u in enumerate(order) if not self.succs[u]]
        if not sinks:
            sinks = list(range(len(order)))
        best_r = max(sinks, key=lambda r: (S[r + 1, L], -r))
        path = []
        r, j = best_r, L
        while not (r < 0 and j == 0):
            if r < 0:
                path.append((-1, j - 1))
                j -= 1
                continue
            u = order[r]
            here = S[r + 1, j]
            sub = (self.match if j > 0 and seq[j - 1] == self.base[u]
                   and seq[j - 1] >= 0 else self.mismatch)
            plist = self.preds[u] or [-1]
            moved = False
            if j > 0:
                for p in plist:
                    pr = rank[p] if p >= 0 else -1
                    if S[pr + 1, j - 1] + sub == here:
                        path.append((u, j - 1))
                        r, j = pr, j - 1
                        moved = True
                        break
            if moved:
                continue
            for p in plist:
                pr = rank[p] if p >= 0 else -1
                if S[pr + 1, j] + self.gap == here:
                    path.append((u, -1))
                    r = pr
                    moved = True
                    break
            if moved:
                continue
            if j > 0 and S[r + 1, j - 1] + self.gap == here:
                path.append((-1, j - 1))
                j -= 1
                continue
            raise AssertionError("POA traceback stuck")
        return path[::-1]

    def add_first(self, seq):
        prev = -1
        for b in seq:
            u = self.new_node(b)
            if prev >= 0:
                self.add_edge(prev, u, 1)
            prev = u

    def add_alignment(self, path, seq):
        prev = -1
        for node, pos in path:
            if pos < 0:
                continue
            b = seq[pos]
            if node >= 0:
                if self.base[node] == b and b >= 0:
                    target = node
                else:
                    target = -1
                    for a in self.aligned[node]:
                        if self.base[a] == b and b >= 0:
                            target = a
                            break
                    if target < 0:
                        target = self.new_node(b)
                        self.link_aligned(target, node)
            else:
                target = self.new_node(b)
            if prev >= 0:
                self.add_edge(prev, target, 1)
            prev = target

    def consensus(self, control=False):
        order = self.order()
        rank = {u: r for r, u in enumerate(order)}
        n = len(self.base)
        score = [0] * n
        best_pred = [-1] * n
        for u in order:
            best = None
            for p, w in zip(self.preds[u], self.pw[u]):
                key = (w, score[p], p if control else -p)
                if best is None or key > best[0]:
                    best = (key, p)
            if best is not None:
                best_pred[u] = best[1]
                score[u] = best[0][1] + best[0][0]
        end = max(range(n), key=lambda u: (score[u], -rank[u]))
        path = []
        u = end
        while u >= 0:
            path.append(u)
            u = best_pred[u]
        return "".join(BASES[self.base[u]] if self.base[u] >= 0 else "N"
                       for u in path[::-1])


def encode(s: str) -> list[int]:
    return ["ACGT".find(c) for c in s]


def consensus(seqs: list[str], max_nodes: int, max_pred: int,
              max_aligned: int, max_seqs: int, max_len: int,
              scores=(8, -6, -8), control: bool = False):
    """(consensus, ok) of one window: ``seqs[0]`` the backbone."""
    if len(seqs) > max_seqs or any(len(s) > max_len for s in seqs):
        return "", False
    g = Graph(max_nodes, max_pred, max_aligned, *scores)
    try:
        for i, s in enumerate(seqs):
            c = encode(s)
            if i == 0:
                g.add_first(c)
            else:
                g.add_alignment(g.align(c), c)
        return g.consensus(control), True
    except Overflow:
        return "", False
