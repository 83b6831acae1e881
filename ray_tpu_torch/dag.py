"""Lazy DAG-of-calls: ``fn.bind(...)`` builds a graph, executed on demand.

Reference analogue: `python/ray/dag/dag_node.py` (``DAGNode``; ``.bind()``
on remote functions/classes; base of Serve graphs and Workflow).  Here a
DAGNode records (remote_function, args, kwargs) where arguments may
themselves be DAGNodes; ``execute()`` submits the whole graph as tasks
with ObjectRef dependencies — the runtime's dependency tracking does the
topological scheduling, and diamond dependencies execute once.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

__all__ = ["DAGNode", "FunctionNode", "InputNode"]


class DAGNode:
    """One node of a lazy call graph."""

    def execute(self, *input_args) -> Any:
        """Submit the graph; returns the root's ObjectRef(s)."""
        return self._submit({}, input_args)

    def _submit(self, memo: Dict[int, Any], input_args: Tuple):
        raise NotImplementedError

    # -- traversal helpers (used by workflow checkpointing) --------------

    def _children(self) -> List["DAGNode"]:
        raise NotImplementedError

    def topo_order(self) -> List["DAGNode"]:
        """Deterministic post-order (children before parents; diamonds
        once)."""
        out: List[DAGNode] = []
        seen: set = set()

        def visit(node: DAGNode):
            if id(node) in seen:
                return
            seen.add(id(node))
            for c in node._children():
                visit(c)
            out.append(node)

        visit(self)
        return out


def _map_args(args, kwargs, fn):
    new_args = [fn(a) if isinstance(a, DAGNode) else a for a in args]
    new_kwargs = {k: fn(v) if isinstance(v, DAGNode) else v
                  for k, v in kwargs.items()}
    return new_args, new_kwargs


class InputNode(DAGNode):
    """Placeholder for the argument passed to ``execute()`` (reference:
    `python/ray/dag/input_node.py`)."""

    def __init__(self, index: int = 0):
        self._index = index

    def _children(self):
        return []

    def _submit(self, memo, input_args):
        return input_args[self._index]


class FunctionNode(DAGNode):
    def __init__(self, remote_function, args: Tuple, kwargs: dict):
        self._fn = remote_function
        self._args = args
        self._kwargs = kwargs

    @property
    def name(self) -> str:
        return self._fn.__name__

    def _children(self):
        return [a for a in list(self._args) + list(self._kwargs.values())
                if isinstance(a, DAGNode)]

    def _submit(self, memo, input_args):
        if id(self) in memo:
            return memo[id(self)]
        args, kwargs = _map_args(self._args, self._kwargs,
                                 lambda n: n._submit(memo, input_args))
        ref = self._fn.remote(*args, **kwargs)
        memo[id(self)] = ref
        return ref

    def __repr__(self):
        return f"FunctionNode({self.name})"
