# Copied from floxer_tpu/pex.py; relative imports resolve to this package's copies.
"""PEX (pigeonhole-exact) partition trees.

Builds the hierarchical partition of a query used for seeded approximate
search and bottom-up verification, based on chapter 6.5.1 of "Flexible
Pattern Matching in Strings" (Navarro & Raffinot).

Reference parity: include/pex.hpp + src/lib/pex.cpp. Tree shapes are pinned
by test/pex_test.cpp (recursive leaf-errors 0/1/2 on a 12-mer with 3 errors;
bottom-up on a 30-mer with 14 errors / 2 leaf errors).

The tree is a pure function of (query_length, query_errors, leaf_errors,
strategy) — it is tiny and stays on host; trees for a whole read batch are
memoized by that key since reads of equal length share one shape.

Storage is array-backed (SoA rows: parent_id, query_index_from,
query_index_to, num_errors) built natively (native/pextree.cpp) with the
Python object builder as fallback and oracle; `PexNode` objects and `Seed`
lists materialize lazily, so the hot chunk path — which consumes only the
derived arrays — never pays for ~1k Python objects per distinct read
length (profiled at ~7 ms per tree, the dominant non-native host cost on
workloads where nearly every read length is unique).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from .utils.mathutils import ceil_div

NULL_ID = -1  # parent id of the root (pex.hpp:60 uses SIZE_MAX; -1 here)


class BuildStrategy(enum.Enum):
    RECURSIVE = "recursive"
    BOTTOM_UP = "bottom_up"


@dataclass
class PexNode:
    """One tree node covering query[query_index_from .. query_index_to]
    (inclusive, pex.hpp:59-76) searchable with num_errors errors."""

    parent_id: int
    query_index_from: int
    query_index_to: int
    num_errors: int

    @property
    def length_of_query_span(self) -> int:
        return self.query_index_to - self.query_index_from + 1

    @property
    def is_root(self) -> bool:
        return self.parent_id == NULL_ID


@dataclass(frozen=True)
class Seed:
    """A leaf's query slice to be searched in the FM-index (search.hpp:17-22).

    sequence is stored as (start, length) into the query, resolved by the
    caller; pex_leaf_index is the index into the tree's leaves vector.
    """

    query_position: int
    length: int
    num_errors: int
    pex_leaf_index: int


class SeedsView:
    """Lazy, immutable sequence of one tree's (sampled) seeds.

    Behaves like the list pex_tree::generate_seeds (pex.cpp:258-277) would
    return — indexing/iteration materialize `Seed` objects on demand — but
    carries the seed-stat arrays (length, errors, query_position,
    leaf_index) precomputed from the tree's leaf rows, so batched consumers
    never touch Python objects."""

    __slots__ = ("arrays", "_objs")

    def __init__(self, arrays: tuple[np.ndarray, ...]):
        self.arrays = arrays
        self._objs: list[Seed | None] = [None] * arrays[0].shape[0]

    def __len__(self) -> int:
        return len(self._objs)

    def __getitem__(self, i: int) -> Seed:
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self._objs)))]
        seed = self._objs[i]
        if seed is None:
            lengths, errors, qpos, leaf = self.arrays
            seed = self._objs[i] = Seed(
                query_position=int(qpos[i]),
                length=int(lengths[i]),
                num_errors=int(errors[i]),
                pex_leaf_index=int(leaf[i]),
            )
        return seed

    def __iter__(self):
        for i in range(len(self._objs)):
            yield self[i]


class PexTree:
    """Array-backed PEX tree; inner_arr/leaf_arr rows are (parent_id,
    query_index_from, query_index_to, num_errors) int64. Node-object views
    (`inner_nodes`, `leaves`, `root`, `parent_of`) materialize lazily with
    stable identity (one object per node)."""

    def __init__(self, inner_arr: np.ndarray, leaf_arr: np.ndarray):
        self.inner_arr = inner_arr
        self.leaf_arr = leaf_arr
        self._inner_nodes: list[PexNode] | None = None
        self._leaves: list[PexNode] | None = None
        self._inner_cache: dict[int, PexNode] = {}

    @property
    def num_inner_nodes(self) -> int:
        return self.inner_arr.shape[0]

    @property
    def num_leaves(self) -> int:
        return self.leaf_arr.shape[0]

    def inner_node(self, node_id: int) -> PexNode:
        """Materialize a single inner node (stable identity)."""
        node = self._inner_cache.get(node_id)
        if node is None:
            row = self.inner_arr[node_id]
            node = self._inner_cache[node_id] = PexNode(
                int(row[0]), int(row[1]), int(row[2]), int(row[3])
            )
        return node

    @property
    def inner_nodes(self) -> list[PexNode]:
        nodes = self._inner_nodes
        if nodes is None:
            cache = self._inner_cache
            rows = self.inner_arr.tolist()
            nodes = [
                cache.get(i) or cache.setdefault(i, PexNode(*row))
                for i, row in enumerate(rows)
            ]
            self._inner_nodes = nodes
        return nodes

    @property
    def leaves(self) -> list[PexNode]:
        nodes = self._leaves
        if nodes is None:
            nodes = self._leaves = [
                PexNode(*row) for row in self.leaf_arr.tolist()
            ]
        return nodes

    @property
    def root(self) -> PexNode:
        root = (
            self.inner_node(0) if self.num_inner_nodes else self.leaves[0]
        )
        assert root.is_root
        return root

    def parent_of(self, child: PexNode) -> PexNode:
        if child.is_root:
            raise ValueError("tried to get parent of PEX tree root")
        return self.inner_node(child.parent_id)

    def generate_seeds(self, seed_sampling_step_size: int = 1) -> SeedsView:
        """One seed per (sampled) leaf, in leaf order (pex.cpp:258-277).
        Seeds are a pure function of the tree, so the view is memoized —
        trees are shared across same-length queries via cached_pex_tree."""
        cache = getattr(self, "_seed_cache", None)
        if cache is None:
            cache = self._seed_cache = {}
        seeds = cache.get(seed_sampling_step_size)
        if seeds is None:
            sampled = self.leaf_arr[::seed_sampling_step_size]
            arrays = (
                sampled[:, 2] - sampled[:, 1] + 1,  # length
                np.ascontiguousarray(sampled[:, 3]),  # errors
                np.ascontiguousarray(sampled[:, 1]),  # query position
                np.arange(
                    0, self.num_leaves, seed_sampling_step_size, dtype=np.int64
                ),  # pex leaf index
            )
            seeds = SeedsView(arrays)
            cache[seed_sampling_step_size] = seeds
        return seeds

    def chain_id_table(self) -> np.ndarray:
        """Per-leaf hierarchical-walk chains as inner-node id rows
        [num_leaves, max_depth], padded with NULL_ID: row l = ids of
        (parent(leaf l), ..., root). Vectorized parent-pointer walk; a
        root-leaf tree yields a [1, 0] table (the caller special-cases the
        chain to the leaf itself, verification.cpp:44-117)."""
        table = getattr(self, "_chain_id_table", None)
        if table is None:
            cur = np.ascontiguousarray(self.leaf_arr[:, 0])
            columns = []
            parents = self.inner_arr[:, 0]
            while cur.size and (cur != NULL_ID).any():
                columns.append(cur)
                cur = np.where(
                    cur == NULL_ID, NULL_ID, parents[np.maximum(cur, 0)]
                )
            table = (
                np.stack(columns, axis=1)
                if columns
                else np.zeros((self.num_leaves, 0), dtype=np.int64)
            )
            self._chain_id_table = table
        return table

    def dot_statement(self, leaf_max_num_errors: int) -> str:
        """Graphviz DOT export (pex.cpp:281-324)."""
        lines = [
            "graph {",
            (
                f'label = "PEX tree for query length {self.root.query_index_to + 1},'
                f" {self.root.num_errors} errors and leaf threshold"
                f' {leaf_max_num_errors} ({self.num_leaves} leaves)";'
            ),
            'labelloc = "t";',
            "node [shape=record];",
        ]
        node_id = 0
        for node in list(self.inner_nodes) + list(self.leaves):
            lines.append(
                f'{node_id} [label="errors: {node.num_errors}'
                f"\\nlength: {node.length_of_query_span}"
                f'\\nrange: [{node.query_index_from},{node.query_index_to}]"];'
            )
            if not node.is_root:
                lines.append(f"{node_id} -- {node.parent_id};")
            node_id += 1
        lines.append("}")
        return "\n".join(lines) + "\n"


class ChainTable:
    """Per-leaf verification chains for one (tree, mode): indexable by leaf
    index, returning the list of `PexNode`s the hierarchical walk visits
    (leaf's parent ... root), [leaf] for a single-root-leaf tree, or
    [root] in direct-full mode. Chains materialize lazily per leaf — the
    wave loop only ever touches the few walks that actually compute."""

    __slots__ = ("_tree", "_direct_full", "_chains")

    def __init__(self, tree: PexTree, direct_full: bool):
        self._tree = tree
        self._direct_full = direct_full
        self._chains: dict[int, list[PexNode]] = {}

    def __len__(self) -> int:
        return self._tree.num_leaves

    def __getitem__(self, leaf_index: int) -> list[PexNode]:
        chain = self._chains.get(leaf_index)
        if chain is None:
            tree = self._tree
            if self._direct_full:
                chain = [tree.root]
            elif tree.num_inner_nodes == 0:
                chain = [tree.leaves[leaf_index]]  # root-leaf tree
            else:
                ids = tree.chain_id_table()[leaf_index]
                chain = [
                    tree.inner_node(int(i)) for i in ids if i != NULL_ID
                ]
            self._chains[leaf_index] = chain
        return chain

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


# seeds-view -> (length, num_errors, query_position, pex_leaf_index) int64
# arrays. SeedsView carries its arrays directly; the dict keyed by list
# identity remains for plain Seed lists (tests and tools construct those).
_SEED_ARRAY_CACHE: dict[int, tuple] = {}


def seed_stat_arrays(seeds):
    if isinstance(seeds, SeedsView):
        return seeds.arrays
    key = id(seeds)
    hit = _SEED_ARRAY_CACHE.get(key)
    if hit is not None and hit[0] is seeds:
        return hit[1]
    n = len(seeds)
    arrays = (
        np.fromiter((s.length for s in seeds), count=n, dtype=np.int64),
        np.fromiter((s.num_errors for s in seeds), count=n, dtype=np.int64),
        np.fromiter((s.query_position for s in seeds), count=n, dtype=np.int64),
        np.fromiter((s.pex_leaf_index for s in seeds), count=n, dtype=np.int64),
    )
    if len(_SEED_ARRAY_CACHE) >= 8192:
        _SEED_ARRAY_CACHE.clear()
    _SEED_ARRAY_CACHE[key] = (seeds, arrays)
    return arrays


class _NodeAccumulator:
    """Target of the Python object builders (fallback and oracle)."""

    def __init__(self):
        self.inner_nodes: list[PexNode] = []
        self.leaves: list[PexNode] = []


def _nodes_to_array(nodes: list[PexNode]) -> np.ndarray:
    arr = np.empty((len(nodes), 4), dtype=np.int64)
    for i, node in enumerate(nodes):
        arr[i, 0] = node.parent_id
        arr[i, 1] = node.query_index_from
        arr[i, 2] = node.query_index_to
        arr[i, 3] = node.num_errors
    return arr


def build_pex_tree_arrays(
    total_query_length: int,
    query_num_errors: int,
    leaf_max_num_errors: int,
    strategy: BuildStrategy = BuildStrategy.RECURSIVE,
) -> tuple[np.ndarray, np.ndarray]:
    """(inner, leaves) node-row arrays; native C++ build with Python
    fallback (identical rows, tests/test_pex.py fuzzes the equivalence)."""
    from .native import native_build_pex_tree

    native = native_build_pex_tree(
        total_query_length,
        query_num_errors,
        leaf_max_num_errors,
        0 if strategy == BuildStrategy.RECURSIVE else 1,
    )
    if native is not None:
        return native

    accum = _NodeAccumulator()
    if strategy == BuildStrategy.RECURSIVE:
        no_error_seed_length = total_query_length // (query_num_errors + 1)
        _add_nodes_recursive(
            accum,
            no_error_seed_length,
            leaf_max_num_errors,
            1,
            total_query_length,
            query_num_errors,
            NULL_ID,
        )
    elif strategy == BuildStrategy.BOTTOM_UP:
        _add_nodes_bottom_up(
            accum, total_query_length, query_num_errors, leaf_max_num_errors
        )
    else:  # pragma: no cover
        raise ValueError(f"unknown build strategy {strategy}")
    return _nodes_to_array(accum.inner_nodes), _nodes_to_array(accum.leaves)


def build_pex_tree(
    total_query_length: int,
    query_num_errors: int,
    leaf_max_num_errors: int,
    strategy: BuildStrategy = BuildStrategy.RECURSIVE,
) -> PexTree:
    tree = PexTree(
        *build_pex_tree_arrays(
            total_query_length, query_num_errors, leaf_max_num_errors, strategy
        )
    )
    root = tree.root
    assert root.num_errors >= query_num_errors
    assert root.num_errors <= query_num_errors + leaf_max_num_errors
    assert root.query_index_from == 0
    assert root.query_index_to == total_query_length - 1
    return tree


@lru_cache(maxsize=4096)
def cached_pex_tree(
    total_query_length: int,
    query_num_errors: int,
    leaf_max_num_errors: int,
    strategy: BuildStrategy,
) -> PexTree:
    """Memoized tree: reads of the same length under one config share a shape."""
    return build_pex_tree(
        total_query_length, query_num_errors, leaf_max_num_errors, strategy
    )


def _add_nodes_recursive(
    tree: _NodeAccumulator,
    no_error_seed_length: int,
    leaf_max_num_errors: int,
    query_index_from: int,
    query_index_to: int,
    num_errors: int,
    parent_id: int,
) -> None:
    """Top-down build from the book; 1-based indices until node creation
    (pex.cpp:110-156). The rightmost leaf absorbs the length remainder."""
    num_leaves_left = ceil_div(num_errors + 1, 2)

    node = PexNode(
        parent_id=parent_id,
        query_index_from=query_index_from - 1,
        query_index_to=query_index_to - 1,
        num_errors=num_errors,
    )

    if num_errors <= leaf_max_num_errors:
        tree.leaves.append(node)
        return

    curr_node_id = len(tree.inner_nodes)
    tree.inner_nodes.append(node)

    query_split_index = query_index_from + num_leaves_left * no_error_seed_length
    num_errors_left = (num_leaves_left * num_errors) // (num_errors + 1)
    num_errors_right = ((num_errors + 1 - num_leaves_left) * num_errors) // (
        num_errors + 1
    )

    _add_nodes_recursive(
        tree,
        no_error_seed_length,
        leaf_max_num_errors,
        query_index_from,
        query_split_index - 1,
        num_errors_left,
        curr_node_id,
    )
    _add_nodes_recursive(
        tree,
        no_error_seed_length,
        leaf_max_num_errors,
        query_split_index,
        query_index_to,
        num_errors_right,
        curr_node_id,
    )


def _add_nodes_bottom_up(
    tree: _NodeAccumulator,
    total_query_length: int,
    query_num_errors: int,
    leaf_max_num_errors: int,
) -> None:
    """Bottom-up build (pex.cpp:158-256): even leaves, pairwise merge upward,
    the last 3 nodes of an odd level merge together; root lands at index 0."""
    base_leaf_weight = leaf_max_num_errors + 1
    num_desired_leaves = ceil_div(query_num_errors + 1, base_leaf_weight)

    if num_desired_leaves == 1:
        tree.leaves.append(
            PexNode(
                parent_id=NULL_ID,
                query_index_from=0,
                query_index_to=total_query_length - 1,
                num_errors=query_num_errors,
            )
        )
        return

    # create_leaves (pex.cpp:215-239): remainder spread over the first leaves
    base_seed_length = total_query_length // num_desired_leaves
    seed_length_remainder = total_query_length % num_desired_leaves
    start = 0
    for i in range(num_desired_leaves):
        length = base_seed_length + (1 if i < seed_length_remainder else 0)
        tree.leaves.append(
            PexNode(
                parent_id=0,  # set during merging
                query_index_from=start,
                query_index_to=start + length - 1,
                num_errors=leaf_max_num_errors,
            )
        )
        start += length

    # secure index 0 for the root (pex.cpp:181)
    tree.inner_nodes.append(PexNode(0, 0, 0, 0))

    # current level as (container, start, count) spans to mirror pex.cpp:184-206
    level_nodes: list[PexNode] = list(tree.leaves)

    while len(level_nodes) > 3:
        level_size = len(level_nodes)
        i = 0
        while i < level_size:
            num_remaining = level_size - i
            if num_remaining == 1:
                break
            num_children = 3 if num_remaining == 3 else 2
            children = level_nodes[i : i + num_children]
            new_parent_id = len(tree.inner_nodes)
            tree.inner_nodes.append(_create_parent_node(children, new_parent_id))
            i += 2 if num_children == 2 else num_children
        level_nodes = tree.inner_nodes[-(level_size // 2) :]

    root = _create_parent_node(level_nodes, 0)
    root.parent_id = NULL_ID
    tree.inner_nodes[0] = root


def _create_parent_node(children: list[PexNode], parent_id: int) -> PexNode:
    """Parent errors = sum(children) + (#children - 1) (pex.cpp:241-256)."""
    assert children
    children_errors = 0
    for child in children:
        child.parent_id = parent_id
        children_errors += child.num_errors
    return PexNode(
        parent_id=0,  # set later
        query_index_from=children[0].query_index_from,
        query_index_to=children[-1].query_index_to,
        num_errors=children_errors + len(children) - 1,
    )
