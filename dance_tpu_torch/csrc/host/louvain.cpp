// Louvain community detection over a symmetric CSR graph (host side).
//
// A copy of dance_tpu/native/louvain.cpp: the port may not import the JAX
// package, so it builds its own (dance_tpu_torch/ops/_build.py,
// build_louvain) with the same compiler flags, which keeps its labels
// bit-identical to the JAX package's. Its behavioural spec is the numpy loop
// louvain_plain in dance_tpu_torch/ops/cluster.py (itself the JAX package's
// replacement for the python-louvain module the reference vendors,
// dance/modules/spatial/spatial_domain/louvain.py:328). Two-phase structure:
// seeded node order, up to `local_iters` local-move sweeps per pass, graph
// aggregation between passes. Seeded std::mt19937_64 makes runs
// deterministic per seed (label ids are compacted by the Python wrapper).

#include <algorithm>
#include <cstdint>
#include <random>
#include <unordered_map>
#include <vector>

extern "C" int32_t louvain_csr(const int64_t* indptr, const int32_t* indices,
                               const float* data, int64_t n, double resolution,
                               uint64_t seed, int32_t max_passes,
                               int32_t local_iters, int32_t* labels_out) {
    std::vector<int64_t> iptr(indptr, indptr + n + 1);
    std::vector<int32_t> idx(indices, indices + indptr[n]);
    std::vector<double> w(data, data + indptr[n]);
    std::vector<int32_t> node_map(n);
    for (int64_t i = 0; i < n; ++i) node_map[i] = (int32_t)i;
    std::mt19937_64 rng(seed);

    int64_t cur_n = n;
    for (int32_t pass = 0; pass < max_passes; ++pass) {
        std::vector<double> deg(cur_n, 0.0);
        double m2 = 0.0;
        for (int64_t u = 0; u < cur_n; ++u) {
            for (int64_t e = iptr[u]; e < iptr[u + 1]; ++e) deg[u] += w[e];
            m2 += deg[u];
        }
        if (m2 == 0.0) break;

        std::vector<int32_t> comm(cur_n);
        for (int64_t i = 0; i < cur_n; ++i) comm[i] = (int32_t)i;
        std::vector<double> comm_deg(deg);
        std::vector<int64_t> order(cur_n);
        for (int64_t i = 0; i < cur_n; ++i) order[i] = i;
        std::shuffle(order.begin(), order.end(), rng);

        bool improved = false;
        std::vector<double> link_w(cur_n, 0.0);
        std::vector<int32_t> touched;
        touched.reserve(256);
        for (int32_t it = 0; it < local_iters; ++it) {
            bool moved = false;
            for (int64_t oi = 0; oi < cur_n; ++oi) {
                const int64_t u = order[oi];
                const int32_t cu = comm[u];
                comm_deg[cu] -= deg[u];
                touched.clear();
                for (int64_t e = iptr[u]; e < iptr[u + 1]; ++e) {
                    const int32_t v = idx[e];
                    if (v == (int32_t)u) continue;
                    const int32_t c = comm[v];
                    if (link_w[c] == 0.0) touched.push_back(c);
                    link_w[c] += w[e];
                }
                // link_w[cu] == 0 when no neighbor shares u's community,
                // matching the numpy spec's dict .get(cu, 0) default
                const double base =
                    link_w[cu] - resolution * comm_deg[cu] * deg[u] / m2;
                int32_t best_c = cu;
                double best_gain = 0.0;
                for (const int32_t c : touched) {
                    const double gain =
                        (link_w[c] - resolution * comm_deg[c] * deg[u] / m2) -
                        base;
                    if (gain > best_gain + 1e-12) {
                        best_c = c;
                        best_gain = gain;
                    }
                }
                for (const int32_t c : touched) link_w[c] = 0.0;
                comm[u] = best_c;
                comm_deg[best_c] += deg[u];
                if (best_c != cu) moved = improved = true;
            }
            if (!moved) break;
        }
        if (!improved) break;

        // compact community ids (first-appearance order; callers only need
        // a consistent partition, the wrapper re-compacts with np.unique)
        std::vector<int32_t> remap(cur_n, -1);
        int32_t new_n = 0;
        for (int64_t u = 0; u < cur_n; ++u)
            if (remap[comm[u]] < 0) remap[comm[u]] = new_n++;
        for (int64_t i = 0; i < n; ++i) node_map[i] = remap[comm[node_map[i]]];
        if (new_n == (int32_t)cur_n) break;  // no shrink: a further pass is a no-op

        // phase 2: aggregate the graph onto communities
        std::vector<std::unordered_map<int32_t, double>> agg(new_n);
        for (int64_t u = 0; u < cur_n; ++u) {
            auto& row = agg[remap[comm[u]]];
            for (int64_t e = iptr[u]; e < iptr[u + 1]; ++e)
                row[remap[comm[idx[e]]]] += w[e];
        }
        std::vector<int64_t> nptr(new_n + 1, 0);
        std::vector<int32_t> nidx;
        std::vector<double> nw;
        for (int32_t u = 0; u < new_n; ++u)
            nptr[u + 1] = nptr[u] + (int64_t)agg[u].size();
        nidx.reserve(nptr[new_n]);
        nw.reserve(nptr[new_n]);
        for (int32_t u = 0; u < new_n; ++u)
            for (const auto& kv : agg[u]) {
                nidx.push_back(kv.first);
                nw.push_back(kv.second);
            }
        iptr.swap(nptr);
        idx.swap(nidx);
        w.swap(nw);
        cur_n = new_n;
    }

    for (int64_t i = 0; i < n; ++i) labels_out[i] = node_map[i];
    int32_t n_comm = 0;
    std::vector<int32_t> seen(n, 0);
    for (int64_t i = 0; i < n; ++i)
        if (!seen[node_map[i]]) {
            seen[node_map[i]] = 1;
            ++n_comm;
        }
    return n_comm;
}
