"""Host-side directed graph with DOT export, used to inspect POA graphs (the
port's copy of ``claragenomicsanalysis_tpu/utils/graph.py``)."""

from collections import defaultdict


class DirectedGraph:
    def __init__(self):
        self._adj: dict[int, list[int]] = defaultdict(list)
        self._labels: dict[int, str] = {}
        self._edge_weights: dict[tuple[int, int], int] = {}

    def add_edge(self, u: int, v: int, weight: int = 1) -> None:
        if v not in self._adj[u]:
            self._adj[u].append(v)
        self._adj.setdefault(v, [])
        self._edge_weights[(u, v)] = self._edge_weights.get((u, v), 0) + weight

    def set_node_label(self, node: int, label: str) -> None:
        self._labels[node] = label

    def nodes(self) -> list[int]:
        return sorted(self._adj)

    def adjacent(self, node: int) -> list[int]:
        return list(self._adj.get(node, []))

    def edge_weight(self, u: int, v: int) -> int:
        return self._edge_weights.get((u, v), 0)

    def serialize_to_dot(self) -> str:
        lines = ["digraph g {"]
        for n in self.nodes():
            label = self._labels.get(n, str(n))
            lines.append(f'  {n} [label="{label}"];')
        for (u, v), w in sorted(self._edge_weights.items()):
            lines.append(f'  {u} -> {v} [label="{w}"];')
        lines.append("}")
        return "\n".join(lines)
