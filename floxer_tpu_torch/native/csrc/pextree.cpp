// Native PEX tree construction returning SoA node arrays.
//
// Mirrors floxer_tpu/pex.py (reference parity: src/lib/pex.cpp:110-256)
// node for node: recursive/top-down builds assign inner-node ids in DFS
// preorder and append leaves left to right; bottom-up builds reserve
// inner id 0 for the root and append merge parents level by level.  The
// Python object builder remains the semantics oracle; this exists because
// building ~1k-node trees as Python dataclasses costs ~7 ms per distinct
// read length (profiled), which dominates the host search stage for
// simulated workloads where nearly every read length is unique.
//
// Node layout per row: parent_id, query_index_from, query_index_to,
// num_errors (pex.hpp:59-76; parent_id -1 for the root).

#include <cstdint>

namespace {

struct Out {
    int64_t* inner;       // [cap_inner][4]
    int64_t* leaves;      // [cap_leaves][4]
    int64_t cap_inner;
    int64_t cap_leaves;
    int64_t num_inner = 0;
    int64_t num_leaves = 0;
    bool overflow = false;

    int64_t push_inner(int64_t parent, int64_t from, int64_t to, int64_t err) {
        if (num_inner >= cap_inner) { overflow = true; return -1; }
        int64_t* row = inner + 4 * num_inner;
        row[0] = parent; row[1] = from; row[2] = to; row[3] = err;
        return num_inner++;
    }
    int64_t push_leaf(int64_t parent, int64_t from, int64_t to, int64_t err) {
        if (num_leaves >= cap_leaves) { overflow = true; return -1; }
        int64_t* row = leaves + 4 * num_leaves;
        row[0] = parent; row[1] = from; row[2] = to; row[3] = err;
        return num_leaves++;
    }
};

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// pex.cpp:110-156 / pex.py _add_nodes_recursive: 1-based indices until
// node creation; the rightmost leaf absorbs the length remainder.
void add_nodes_recursive(
    Out& out, int64_t no_error_seed_length, int64_t leaf_max_num_errors,
    int64_t query_index_from, int64_t query_index_to, int64_t num_errors,
    int64_t parent_id) {
    if (out.overflow) return;
    int64_t const num_leaves_left = ceil_div(num_errors + 1, 2);

    if (num_errors <= leaf_max_num_errors) {
        out.push_leaf(parent_id, query_index_from - 1, query_index_to - 1,
                      num_errors);
        return;
    }
    int64_t const curr = out.push_inner(
        parent_id, query_index_from - 1, query_index_to - 1, num_errors);
    if (out.overflow) return;

    int64_t const split = query_index_from + num_leaves_left * no_error_seed_length;
    int64_t const err_left = (num_leaves_left * num_errors) / (num_errors + 1);
    int64_t const err_right =
        ((num_errors + 1 - num_leaves_left) * num_errors) / (num_errors + 1);

    add_nodes_recursive(out, no_error_seed_length, leaf_max_num_errors,
                        query_index_from, split - 1, err_left, curr);
    add_nodes_recursive(out, no_error_seed_length, leaf_max_num_errors,
                        split, query_index_to, err_right, curr);
}

// pex.cpp:158-256 / pex.py _add_nodes_bottom_up: even leaves with the
// remainder spread over the first ones, pairwise merge upward (last 3 of
// an odd level merge together), root placed at inner index 0.
void add_nodes_bottom_up(
    Out& out, int64_t total_query_length, int64_t query_num_errors,
    int64_t leaf_max_num_errors) {
    int64_t const base_leaf_weight = leaf_max_num_errors + 1;
    int64_t const num_desired_leaves =
        ceil_div(query_num_errors + 1, base_leaf_weight);

    if (num_desired_leaves == 1) {
        out.push_leaf(-1, 0, total_query_length - 1, query_num_errors);
        return;
    }

    int64_t const base_seed_length = total_query_length / num_desired_leaves;
    int64_t const remainder = total_query_length % num_desired_leaves;
    int64_t start = 0;
    for (int64_t i = 0; i < num_desired_leaves; ++i) {
        int64_t const length = base_seed_length + (i < remainder ? 1 : 0);
        out.push_leaf(0, start, start + length - 1, leaf_max_num_errors);
        if (out.overflow) return;
        start += length;
    }

    // secure index 0 for the root (pex.cpp:181)
    out.push_inner(0, 0, 0, 0);
    if (out.overflow) return;

    // current level as (is_leaf, index) handles; leaves first
    int64_t const max_level = num_desired_leaves;
    // level buffer: encode leaf i as i, inner j as -(j + 2) to avoid heap
    // allocation helpers; decode via sign
    int64_t* level = new int64_t[max_level];
    int64_t level_size = num_desired_leaves;
    for (int64_t i = 0; i < num_desired_leaves; ++i) level[i] = i;

    auto row_of = [&](int64_t handle) -> int64_t* {
        if (handle >= 0) return out.leaves + 4 * handle;
        return out.inner + 4 * (-(handle + 2));
    };

    auto create_parent = [&](int64_t* children, int64_t count,
                             int64_t parent_id) -> int64_t {
        // pex.cpp:241-256: parent errors = sum(children) + (count - 1)
        int64_t children_errors = 0;
        for (int64_t c = 0; c < count; ++c) {
            int64_t* row = row_of(children[c]);
            row[0] = parent_id;
            children_errors += row[3];
        }
        int64_t const from = row_of(children[0])[1];
        int64_t const to = row_of(children[count - 1])[2];
        return out.push_inner(0, from, to, children_errors + count - 1);
    };

    while (level_size > 3) {
        int64_t next_size = 0;
        int64_t i = 0;
        while (i < level_size) {
            int64_t const num_remaining = level_size - i;
            if (num_remaining == 1) break;
            int64_t const num_children = num_remaining == 3 ? 3 : 2;
            int64_t const new_parent_id = out.num_inner;
            int64_t const idx =
                create_parent(level + i, num_children, new_parent_id);
            if (out.overflow) { delete[] level; return; }
            level[next_size++] = -(idx + 2);
            i += num_children == 2 ? 2 : num_children;
        }
        // mirrors pex.py: level_nodes = inner_nodes[-(level_size // 2):]
        level_size = next_size;
    }

    int64_t const root_idx = create_parent(level, level_size, 0);
    delete[] level;
    if (out.overflow) return;
    // move the root into slot 0 (pex.py sets inner_nodes[0] = root); the
    // freshly-pushed row at root_idx becomes dead only when root_idx != 0,
    // i.e. it IS the last push — pop it after copying
    int64_t* root_row = out.inner + 4 * root_idx;
    root_row[0] = -1;
    if (root_idx != 0) {
        int64_t* slot0 = out.inner;
        for (int c = 0; c < 4; ++c) slot0[c] = root_row[c];
        out.num_inner -= 1;  // the copy source was the last row
    }
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 on capacity overflow, 2 on bad arguments.
int floxer_build_pex_tree(
    int64_t total_query_length, int64_t query_num_errors,
    int64_t leaf_max_num_errors, int64_t strategy,  // 0 recursive, 1 bottom-up
    int64_t* out_inner, int64_t cap_inner,
    int64_t* out_leaves, int64_t cap_leaves,
    int64_t* out_num_inner, int64_t* out_num_leaves) {
    if (total_query_length <= 0 || query_num_errors < 0 ||
        leaf_max_num_errors < 0) {
        return 2;
    }
    Out out{out_inner, out_leaves, cap_inner, cap_leaves};
    if (strategy == 0) {
        int64_t const no_error_seed_length =
            total_query_length / (query_num_errors + 1);
        add_nodes_recursive(out, no_error_seed_length, leaf_max_num_errors,
                            1, total_query_length, query_num_errors, -1);
    } else if (strategy == 1) {
        add_nodes_bottom_up(out, total_query_length, query_num_errors,
                            leaf_max_num_errors);
    } else {
        return 2;
    }
    if (out.overflow) return 1;
    *out_num_inner = out.num_inner;
    *out_num_leaves = out.num_leaves;
    return 0;
}

}  // extern "C"
