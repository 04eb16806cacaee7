# Copied from floxer_tpu/utils/introsort.py; relative imports resolve to this package's copies.
"""Faithful replica of libstdc++'s std::sort (introsort).

The reference orders anchor groups with std::ranges::sort
(floxer's src/lib/search.cpp:204-229), which in libstdc++
delegates to the classic introsort of bits/stl_algo.h. Two comparators
are used there:

  count_first:  comp(a, b) = (a.count != b.count) ? a.count < b.count
                                                  : a.err < b.err
  errors_first: comp(a, b) = (a.err != b.err) ? a.count < b.count : false

The errors_first predicate is NOT a strict weak ordering (incomparability
is not transitive), so the resulting permutation is defined by the sort
ALGORITHM, not by the predicate alone — and even for the valid count_first
predicate, ties between equal keys land in an algorithm-defined (not
input-stable) order. Reproducing the reference's output bit-for-bit
therefore requires reproducing introsort itself: median-of-three quicksort
to a 2*floor(log2(n)) depth limit, heapsort fallback, threshold-16
insertion-sort finish — each sub-algorithm exactly as implemented in
libstdc++ (GCC 15 bits/stl_algo.h + bits/stl_heap.h; stable across GCC
releases for decades). The C++ engine (native/search.cpp) gets this for
free by calling std::sort with the literal comparator; this module is the
Python-engine equivalent, and tests/test_native_search.py fuzzes the two
against each other.

Degenerate comparators make std::sort formally UB, but the implementation
is well-defined for any comparator that never lies about out-of-range
elements: every loop in introsort is bounded by positional guards except
__unguarded_linear_insert / __unguarded_partition, whose sentinels only
require comp(x, x) == False — which both comparators above satisfy.
"""

from __future__ import annotations

_S_THRESHOLD = 16


def _lg(n: int) -> int:
    return n.bit_length() - 1


def _move_median_to_first(a, result, i1, i2, i3, comp):
    # bits/stl_algo.h __move_median_to_first
    if comp(a[i1], a[i2]):
        if comp(a[i2], a[i3]):
            a[result], a[i2] = a[i2], a[result]
        elif comp(a[i1], a[i3]):
            a[result], a[i3] = a[i3], a[result]
        else:
            a[result], a[i1] = a[i1], a[result]
    elif comp(a[i1], a[i3]):
        a[result], a[i1] = a[i1], a[result]
    elif comp(a[i2], a[i3]):
        a[result], a[i3] = a[i3], a[result]
    else:
        a[result], a[i2] = a[i2], a[result]


def _unguarded_partition(a, first, last, pivot, comp):
    # bits/stl_algo.h __unguarded_partition
    while True:
        while comp(a[first], a[pivot]):
            first += 1
        last -= 1
        while comp(a[pivot], a[last]):
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _unguarded_partition_pivot(a, first, last, comp):
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, comp)
    return _unguarded_partition(a, first + 1, last, first, comp)


def _push_heap(a, first, hole, top, value, comp):
    # bits/stl_heap.h __push_heap
    parent = (hole - 1) // 2
    while hole > top and comp(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _adjust_heap(a, first, hole, length, value, comp):
    # bits/stl_heap.h __adjust_heap
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if comp(a[first + second], a[first + (second - 1)]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if (length & 1) == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + (second - 1)]
        hole = second - 1
    _push_heap(a, first, hole, top, value, comp)


def _make_heap(a, first, last, comp):
    # bits/stl_heap.h __make_heap
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, first, parent, length, value, comp)
        if parent == 0:
            return
        parent -= 1


def _pop_heap(a, first, last, result, comp):
    # bits/stl_heap.h __pop_heap
    value = a[result]
    a[result] = a[first]
    _adjust_heap(a, first, 0, last - first, value, comp)


def _sort_heap(a, first, last, comp):
    # bits/stl_heap.h __sort_heap
    while last - first > 1:
        last -= 1
        _pop_heap(a, first, last, last, comp)


def _heap_sort_range(a, first, last, comp):
    # __partial_sort(first, last, last): __heap_select then __sort_heap
    # (the __heap_select scan past `middle` is empty when middle == last)
    _make_heap(a, first, last, comp)
    _sort_heap(a, first, last, comp)


def _introsort_loop(a, first, last, depth_limit, comp):
    # bits/stl_algo.h __introsort_loop
    while last - first > _S_THRESHOLD:
        if depth_limit == 0:
            _heap_sort_range(a, first, last, comp)
            return
        depth_limit -= 1
        cut = _unguarded_partition_pivot(a, first, last, comp)
        _introsort_loop(a, cut, last, depth_limit, comp)
        last = cut


def _unguarded_linear_insert(a, last, comp):
    # bits/stl_algo.h __unguarded_linear_insert (val-vs-iter comparator)
    value = a[last]
    nxt = last - 1
    while comp(value, a[nxt]):
        a[last] = a[nxt]
        last = nxt
        nxt -= 1
    a[last] = value


def _insertion_sort(a, first, last, comp):
    # bits/stl_algo.h __insertion_sort
    if first == last:
        return
    for i in range(first + 1, last):
        if comp(a[i], a[first]):
            value = a[i]
            a[first + 1 : i + 1] = a[first:i]
            a[first] = value
        else:
            _unguarded_linear_insert(a, i, comp)


def _final_insertion_sort(a, first, last, comp):
    # bits/stl_algo.h __final_insertion_sort
    if last - first > _S_THRESHOLD:
        _insertion_sort(a, first, first + _S_THRESHOLD, comp)
        for i in range(first + _S_THRESHOLD, last):
            _unguarded_linear_insert(a, i, comp)
    else:
        _insertion_sort(a, first, last, comp)


def std_sort(a: list, comp) -> None:
    """In-place std::sort(a.begin(), a.end(), comp), libstdc++ semantics."""
    if len(a) < 2:
        return
    _introsort_loop(a, 0, len(a), _lg(len(a)) * 2, comp)
    _final_insertion_sort(a, 0, len(a), comp)


def count_first_comp(count_err_a, count_err_b) -> bool:
    """search.cpp:206-212 (count, then errors)."""
    ca, ea = count_err_a
    cb, eb = count_err_b
    if ca != cb:
        return ca < cb
    return ea < eb


def errors_first_comp(count_err_a, count_err_b) -> bool:
    """search.cpp:215-223 — the degenerate predicate, verbatim: compares
    COUNTS whenever the error counts differ, else 'err < err' (never)."""
    ca, ea = count_err_a
    cb, eb = count_err_b
    if ea != eb:
        return ca < cb
    return False
