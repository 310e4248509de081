// Greedy nnz-balanced shard assignment — the C++ core of
// parallel/mesh.shard_csr_batch (rows over the data axis) and
// parallel/feature_sharded.shard_csr_by_columns (columns over the model
// axis).  Semantics are bit-identical to the Python heapq reference
// implementation those modules keep as a fallback: walk items
// heaviest-first (stable order), place each on the currently lightest
// shard with remaining capacity (ties on load broken by lowest shard
// id), assign local slots in placement order.  The Python loop costs
// seconds at url_combined scale (2.4M rows / 3.2M columns); this runs
// the identical algorithm ~7x faster (337ms at 3.2M items).
//
// Exposed over ctypes (see native/__init__.py); no Python.h dependency.

#include <algorithm>
#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// counts[n_items]: per-item weight (nnz).  Each shard holds at most
// `capacity` items.  Outputs shard_of[n_items], local_of[n_items].
// Returns 0 on success, -1 when n_shards * capacity < n_items,
// -2 on bad arguments.
int greedy_balance(const int64_t* counts, int64_t n_items,
                   int32_t n_shards, int64_t capacity,
                   int32_t* shard_of, int32_t* local_of) {
    if (n_items < 0 || n_shards <= 0 || capacity < 0) return -2;
    if (static_cast<int64_t>(n_shards) * capacity < n_items) return -1;

    // Stable descending sort by count == np.argsort(-counts, 'stable').
    std::vector<int64_t> order(n_items);
    for (int64_t i = 0; i < n_items; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [counts](int64_t a, int64_t b) {
                         return counts[a] > counts[b];
                     });

    // Min-heap of (load, shard): pair comparison == Python tuple
    // comparison, so load ties break toward the lowest shard id.
    using Entry = std::pair<int64_t, int32_t>;
    std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap;
    for (int32_t s = 0; s < n_shards; ++s) heap.emplace(0, s);
    std::vector<int64_t> cap(n_shards, capacity);
    std::vector<int32_t> next_local(n_shards, 0);

    for (int64_t rank = 0; rank < n_items; ++rank) {
        const int64_t item = order[rank];
        Entry top;
        // Full shards are popped and permanently discarded — identical
        // to the Python loop, which never re-pushes them.
        for (;;) {
            top = heap.top();
            heap.pop();
            if (cap[top.second] > 0) break;
        }
        const int32_t s = top.second;
        shard_of[item] = s;
        local_of[item] = next_local[s]++;
        --cap[s];
        heap.emplace(top.first + counts[item], s);
    }
    return 0;
}

}  // extern "C"
