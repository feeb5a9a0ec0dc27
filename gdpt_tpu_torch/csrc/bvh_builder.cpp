// Native binned-SAH BVH builder.
//
// Host-side replacement for Embree's rtcCommitScene build phase
// (reference: src/scene.cpp:27); a copy of
// gdpt_tpu/accel/native/bvh_builder.cpp. Emits the flat depth-first
// layout with miss links that accel/bvh.py documents and
// accel/packet_trace.build_packet_table collapses. Exposed through a C
// ABI; accel/bvh.py compiles it with g++ at first use into
// build/gdpt_tpu_torch/ and loads it with ctypes.
//
// Build: g++ -O3 -fPIC -std=c++17 -ffp-contract=off -shared

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
    double x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Builder {
    const Vec3 *bmin, *bmax, *cent;
    int leaf_size, n_bins;
    std::vector<int64_t> order;
    // Output arrays (indexed by node id, DFS order).
    std::vector<float> node_bmin, node_bmax;
    std::vector<int32_t> first, count, miss;
    int64_t max_nodes;

    int64_t emit(int64_t lo, int64_t hi) {
        int64_t idx = (int64_t)count.size();
        if (idx >= max_nodes) return -1;
        Vec3 lo_b = {std::numeric_limits<double>::infinity(),
                     std::numeric_limits<double>::infinity(),
                     std::numeric_limits<double>::infinity()};
        Vec3 hi_b = {-lo_b.x, -lo_b.y, -lo_b.z};
        for (int64_t i = lo; i < hi; ++i) {
            lo_b = vmin(lo_b, bmin[order[i]]);
            hi_b = vmax(hi_b, bmax[order[i]]);
        }
        node_bmin.insert(node_bmin.end(), {(float)lo_b.x, (float)lo_b.y, (float)lo_b.z});
        node_bmax.insert(node_bmax.end(), {(float)hi_b.x, (float)hi_b.y, (float)hi_b.z});
        first.push_back(-1);
        count.push_back(0);
        miss.push_back(0);

        int64_t n = hi - lo;
        if (n <= leaf_size) {
            first[idx] = (int32_t)lo;
            count[idx] = (int32_t)n;
            miss[idx] = (int32_t)(idx + 1);
            return idx;
        }

        // Centroid bounds + split axis.
        Vec3 clo = {lo_b.x, lo_b.y, lo_b.z}, chi;
        clo = {std::numeric_limits<double>::infinity(),
               std::numeric_limits<double>::infinity(),
               std::numeric_limits<double>::infinity()};
        chi = {-clo.x, -clo.y, -clo.z};
        for (int64_t i = lo; i < hi; ++i) {
            clo = vmin(clo, cent[order[i]]);
            chi = vmax(chi, cent[order[i]]);
        }
        double ext[3] = {chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
        int axis = 0;
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        int64_t split = -1;
        if (ext[axis] > 0.0) {
            // Binned SAH.
            const int B = n_bins;
            std::vector<int64_t> bin_count(B, 0);
            std::vector<Vec3> bin_lo(B, clo), bin_hi(B, chi);
            for (int b = 0; b < B; ++b) {
                bin_lo[b] = {std::numeric_limits<double>::infinity(),
                             std::numeric_limits<double>::infinity(),
                             std::numeric_limits<double>::infinity()};
                bin_hi[b] = {-bin_lo[b].x, -bin_lo[b].y, -bin_lo[b].z};
            }
            const double c0 = axis == 0 ? clo.x : (axis == 1 ? clo.y : clo.z);
            const double inv = B / ext[axis];
            auto bin_of = [&](int64_t p) {
                const Vec3 &c = cent[p];
                double v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
                int b = (int)((v - c0) * inv);
                return std::min(std::max(b, 0), B - 1);
            };
            for (int64_t i = lo; i < hi; ++i) {
                int64_t p = order[i];
                int b = bin_of(p);
                bin_count[b]++;
                bin_lo[b] = vmin(bin_lo[b], bmin[p]);
                bin_hi[b] = vmax(bin_hi[b], bmax[p]);
            }
            auto sa = [](const Vec3 &l, const Vec3 &h) {
                double dx = std::max(h.x - l.x, 0.0);
                double dy = std::max(h.y - l.y, 0.0);
                double dz = std::max(h.z - l.z, 0.0);
                return dx * dy + dy * dz + dz * dx;
            };
            // Suffix sweep.
            std::vector<double> right_sa(B, 0.0);
            std::vector<int64_t> right_n(B, 0);
            Vec3 acc_lo = bin_lo[B - 1], acc_hi = bin_hi[B - 1];
            int64_t acc_n = 0;
            for (int b = B - 1; b >= 1; --b) {
                if (b < B - 1) {
                    acc_lo = vmin(acc_lo, bin_lo[b]);
                    acc_hi = vmax(acc_hi, bin_hi[b]);
                } else {
                    acc_lo = bin_lo[b];
                    acc_hi = bin_hi[b];
                }
                acc_n += bin_count[b];
                right_sa[b] = sa(acc_lo, acc_hi);
                right_n[b] = acc_n;
            }
            // Prefix sweep + best split.
            double best_cost = std::numeric_limits<double>::infinity();
            int best_b = -1;
            acc_n = 0;
            bool have = false;
            Vec3 plo{}, phi{};
            for (int b = 0; b < B - 1; ++b) {
                if (bin_count[b] > 0) {
                    if (!have) {
                        plo = bin_lo[b];
                        phi = bin_hi[b];
                        have = true;
                    } else {
                        plo = vmin(plo, bin_lo[b]);
                        phi = vmax(phi, bin_hi[b]);
                    }
                }
                acc_n += bin_count[b];
                if (acc_n == 0 || right_n[b + 1] == 0) continue;
                double cost = sa(plo, phi) * acc_n + right_sa[b + 1] * right_n[b + 1];
                if (cost < best_cost) {
                    best_cost = cost;
                    best_b = b;
                }
            }
            if (best_b >= 0) {
                auto mid = std::partition(
                    order.begin() + lo, order.begin() + hi,
                    [&](int64_t p) { return bin_of(p) <= best_b; });
                split = mid - order.begin();
                if (split == lo || split == hi) split = -1;
            }
        }
        if (split < 0) {
            // Median fallback.
            int64_t mid = lo + n / 2;
            std::nth_element(
                order.begin() + lo, order.begin() + mid, order.begin() + hi,
                [&](int64_t a, int64_t b) {
                    const Vec3 &ca = cent[a], &cb = cent[b];
                    double va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
                    double vb = axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
                    return va < vb;
                });
            split = mid;
        }
        if (emit(lo, split) < 0) return -1;
        if (emit(split, hi) < 0) return -1;
        miss[idx] = (int32_t)count.size();
        return idx;
    }
};

}  // namespace

extern "C" int64_t gdpt_build_bvh(
    int64_t n, const double *bmin, const double *bmax, const double *cent,
    int leaf_size, int n_bins,
    float *out_bmin, float *out_bmax, int32_t *out_first, int32_t *out_count,
    int32_t *out_miss, int32_t *out_prim_order) {
    if (n <= 0) return -1;
    Builder b;
    b.bmin = (const Vec3 *)bmin;
    b.bmax = (const Vec3 *)bmax;
    b.cent = (const Vec3 *)cent;
    b.leaf_size = leaf_size;
    b.n_bins = n_bins;
    b.max_nodes = 2 * n;
    b.order.resize(n);
    for (int64_t i = 0; i < n; ++i) b.order[i] = i;
    b.node_bmin.reserve(6 * n);
    b.node_bmax.reserve(6 * n);
    b.first.reserve(2 * n);
    b.count.reserve(2 * n);
    b.miss.reserve(2 * n);
    if (b.emit(0, n) < 0) return -1;
    int64_t n_nodes = (int64_t)b.count.size();
    std::memcpy(out_bmin, b.node_bmin.data(), 3 * sizeof(float) * n_nodes);
    std::memcpy(out_bmax, b.node_bmax.data(), 3 * sizeof(float) * n_nodes);
    std::memcpy(out_first, b.first.data(), sizeof(int32_t) * n_nodes);
    std::memcpy(out_count, b.count.data(), sizeof(int32_t) * n_nodes);
    std::memcpy(out_miss, b.miss.data(), sizeof(int32_t) * n_nodes);
    for (int64_t i = 0; i < n; ++i) out_prim_order[i] = (int32_t)b.order[i];
    return n_nodes;
}
