// Native runtime kernels for deltapq-tpu: the inherently-sequential
// host-side paths that NumPy cannot vectorize.
//
// Behavioral equivalents in the reference:
//  - dtc_decode / dtc_parse: the DTC stream pointer-walk of
//    query_processing_scan_compressed_codes_opt_in_memory
//    (deltapq_create_approx_tree.h:3786-3858)
//  - dfs_layout: dfs_node_layout (deltapq_create_approx_tree.h:1156-1183)
//  - scan_query: the single-query compressed ADC scan with per-depth
//    (code, distance) stacks and a top-k max-heap
//    (deltapq_create_approx_tree.h:2805-2984) — used as the host-side
//    oracle and CPU baseline.
//
// Exposed as a C ABI for ctypes.  Build: see build.py (g++ -O3 -shared).

#include <cstdint>
#include <cstring>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// Decode a DTC byte stream into an [n_codes, M] uint8 code array in DFS
// order.  Returns bytes consumed, or -1 on error.
long long dtc_decode(const uint8_t* stream, long long n_bytes,
                     long long n_codes, int M, uint8_t* out_codes) {
    if (M > 8 || n_codes <= 0) return -1;
    uint8_t stack[32][8];
    long long off = 0;
    for (int m = 0; m < M; m++) stack[0][m] = stream[off++];
    std::memcpy(out_codes, stack[0], M);

    long long i = 1;
    while (i + 1 < n_codes) {
        int depths = stream[off++];
        for (int half = 0; half < 2; half++, i++) {
            int d = (half == 0) ? (depths & 0x0F) : ((depths >> 4) & 0x0F);
            std::memcpy(stack[d], stack[d - 1], M);
            int bm = stream[off++];
            for (int m = 0; m < M; m++)
                if (bm & (1 << m)) stack[d][m] = stream[off++];
            std::memcpy(out_codes + i * M, stack[d], M);
        }
    }
    if (i == n_codes - 1) {
        int d = stream[off++];
        std::memcpy(stack[d], stack[d - 1], M);
        int bm = stream[off++];
        for (int m = 0; m < M; m++)
            if (bm & (1 << m)) stack[d][m] = stream[off++];
        std::memcpy(out_codes + i * M, stack[d], M);
    }
    return (off <= n_bytes) ? off : -1;
}

// Parse a DTC stream into per-node columns: depth[n], bitmap[n],
// diff_off[n+1] (int64), diff_to[total_diffs].  Returns total diffs
// (including the root's M pseudo-diffs at diff_to[0..M-1]) or -1.
long long dtc_parse(const uint8_t* stream, long long n_bytes,
                    long long n_codes, int M, uint8_t* depth,
                    uint8_t* bitmap, long long* diff_off,
                    uint8_t* diff_to) {
    if (M > 8 || n_codes <= 0) return -1;
    long long off = 0, nd_total = 0;
    depth[0] = 0;
    bitmap[0] = (M < 8) ? ((1 << M) - 1) : 0xFF;
    diff_off[0] = 0;
    for (int m = 0; m < M; m++) diff_to[nd_total++] = stream[off++];
    diff_off[1] = nd_total;

    long long i = 1;
    while (i + 1 < n_codes) {
        int depths = stream[off++];
        for (int half = 0; half < 2; half++, i++) {
            depth[i] = (half == 0) ? (depths & 0x0F)
                                   : ((depths >> 4) & 0x0F);
            int bm = stream[off++];
            bitmap[i] = (uint8_t)bm;
            for (int m = 0; m < M; m++)
                if (bm & (1 << m)) diff_to[nd_total++] = stream[off++];
            diff_off[i + 1] = nd_total;
        }
    }
    if (i == n_codes - 1) {
        depth[i] = stream[off++];
        int bm = stream[off++];
        bitmap[i] = (uint8_t)bm;
        for (int m = 0; m < M; m++)
            if (bm & (1 << m)) diff_to[nd_total++] = stream[off++];
        diff_off[i + 1] = nd_total;
    }
    return (off <= n_bytes) ? nd_total : -1;
}

// DFS numbering over a CSR forest (children pre-sorted by the caller).
// child_sorted/offsets: CSR adjacency [n]/[n+1]; outputs: dfs_vec[n]
// (vec ids in DFS order), dfs_parent[n] (DFS pos of parent, -1 root),
// dfs_depth[n].  Returns number of nodes laid out (== n when the tree
// spans) or -1 on stack error.
long long dfs_layout(long long n, const uint32_t* child_sorted,
                     const long long* offsets, uint32_t root_id,
                     uint32_t* dfs_vec, int32_t* dfs_parent,
                     uint8_t* dfs_depth, int64_t* pos_of) {
    std::vector<long long> cur(offsets, offsets + n);
    std::vector<uint32_t> stack;
    stack.reserve(64);
    dfs_vec[0] = root_id;
    dfs_parent[0] = -1;
    dfs_depth[0] = 0;
    pos_of[root_id] = 0;
    long long idx = 1;
    stack.push_back(root_id);
    while (!stack.empty()) {
        uint32_t v = stack.back();
        if (cur[v] < offsets[v + 1]) {
            uint32_t c = child_sorted[cur[v]++];
            int64_t pv = pos_of[v];
            dfs_vec[idx] = c;
            dfs_parent[idx] = (int32_t)pv;
            dfs_depth[idx] = dfs_depth[pv] + 1;
            pos_of[c] = idx;
            idx++;
            stack.push_back(c);
        } else {
            stack.pop_back();
        }
    }
    return idx;
}

// Single-query compressed-stream ADC scan (reference semantics: double
// accumulators, per-depth stacks, size-k max-heap).  table: [M, K] f32.
// Results: out_dist/out_id arrays of length top_k (ascending).  Returns
// number of results.
long long scan_query(const uint8_t* stream, long long n_codes, int M,
                     int K, const float* table, int top_k,
                     float* out_dist, int64_t* out_id) {
    if (M > 8) return -1;
    uint8_t stack[32][8];
    double dstack[32];
    long long off = 0;
    double qd = 0;
    for (int m = 0; m < M; m++) {
        uint8_t cid = stream[off++];
        stack[0][m] = cid;
        qd += table[m * K + cid];
    }
    dstack[0] = qd;
    typedef std::pair<double, long long> PDI;
    std::priority_queue<PDI> heap;  // max-heap on distance
    heap.emplace(qd, 0);

    long long i = 1;
    auto process = [&](int d, long long pos) {
        std::memcpy(stack[d], stack[d - 1], M);
        double dist = dstack[d - 1];
        int bm = stream[off++];
        for (int m = 0; m < M; m++) {
            if (bm & (1 << m)) {
                uint8_t to = stream[off++];
                dist -= table[m * K + stack[d][m]];
                dist += table[m * K + to];
                stack[d][m] = to;
            }
        }
        dstack[d] = dist;
        if ((long long)heap.size() < top_k) heap.emplace(dist, pos);
        else if (dist < heap.top().first) {
            heap.pop();
            heap.emplace(dist, pos);
        }
    };
    while (i + 1 < n_codes) {
        int depths = stream[off++];
        process(depths & 0x0F, i);
        process((depths >> 4) & 0x0F, i + 1);
        i += 2;
    }
    if (i == n_codes - 1) {
        int d = stream[off++];  // leftover node: full-byte depth
        process(d, i);          // process() reads bitmap + diffs at off
    }
    long long nres = (long long)heap.size();
    for (long long j = nres - 1; j >= 0; j--) {
        out_dist[j] = (float)heap.top().first;
        out_id[j] = heap.top().second;
        heap.pop();
    }
    return nres;
}

// Sequential diff-index decode (create_diff_index format, K<=256).
long long diff_index_decode(const uint8_t* stream, long long n_bytes,
                            long long n_codes, int M, uint8_t* out_codes) {
    if (M > 8 || n_codes <= 0) return -1;
    long long off = 0;
    for (int m = 0; m < M; m++) out_codes[m] = stream[off++];
    for (long long i = 1; i < n_codes; i++) {
        std::memcpy(out_codes + i * M, out_codes + (i - 1) * M, M);
        int bm = stream[off++];
        for (int m = 0; m < M; m++)
            if (bm & (1 << m)) out_codes[i * M + m] = stream[off++];
    }
    return (off <= n_bytes) ? off : -1;
}

}  // extern "C"
