// Friends-of-friends spatio-spectral merging core.
//
// C++ implementation of the detection-merging traversal
// (origin_tpu/detect/merging.py::_merge_groups, mirroring reference
// lib_origin.py:1259-1316): for each unmatched seed, neighbours within
// tol_spat join the group, with candidates farther than tol_spat*sqrt(2)
// from the seed admitted only when |dz| < tol_spec; traversal is an
// index-ordered DFS with immediate descent, identical to the Python code.
//
// The Python loop is O(N^2) with large constants; this core uses a uniform
// spatial grid to enumerate neighbour candidates and runs the whole
// traversal in native code.  Exposed via a plain C ABI for ctypes.

#include <cmath>
#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

// x, y, z: detection coordinates (n).  imatch: output group seed per row.
// Returns 0 on success.
int fof_merge_groups(
    const double* x,
    const double* y,
    const double* z,
    int64_t n,
    double tol_spat,
    double tol_spec,
    int64_t* imatch)
{
    if (n <= 0) return 0;

    std::vector<uint8_t> matched(n, 0);
    for (int64_t i = 0; i < n; ++i) imatch[i] = i;

    // uniform grid over (x, y) with cell size tol_spat
    double xmin = x[0], ymin = y[0], xmax = x[0], ymax = y[0];
    for (int64_t i = 1; i < n; ++i) {
        xmin = std::min(xmin, x[i]); xmax = std::max(xmax, x[i]);
        ymin = std::min(ymin, y[i]); ymax = std::max(ymax, y[i]);
    }
    const double cell = std::max(tol_spat, 1e-9);
    const int64_t ncx = (int64_t)((xmax - xmin) / cell) + 1;
    const int64_t ncy = (int64_t)((ymax - ymin) / cell) + 1;
    std::vector<std::vector<int32_t>> grid((size_t)(ncx * ncy));
    auto cell_of = [&](int64_t i) {
        int64_t cx = (int64_t)((x[i] - xmin) / cell);
        int64_t cy = (int64_t)((y[i] - ymin) / cell);
        return cy * ncx + cx;
    };
    for (int64_t i = 0; i < n; ++i)
        grid[(size_t)cell_of(i)].push_back((int32_t)i);

    const double sq2 = tol_spat * std::sqrt(2.0);
    std::vector<int32_t> cand;     // scratch candidate list
    struct Frame { std::vector<int32_t> cands; size_t pos; };
    std::vector<Frame> stack;

    auto candidates_of = [&](int64_t node, std::vector<int32_t>& out) {
        out.clear();
        int64_t cx = (int64_t)((x[node] - xmin) / cell);
        int64_t cy = (int64_t)((y[node] - ymin) / cell);
        for (int64_t dy = -1; dy <= 1; ++dy) {
            int64_t yy = cy + dy;
            if (yy < 0 || yy >= ncy) continue;
            for (int64_t dx = -1; dx <= 1; ++dx) {
                int64_t xx = cx + dx;
                if (xx < 0 || xx >= ncx) continue;
                for (int32_t j : grid[(size_t)(yy * ncx + xx)]) {
                    if (matched[j]) continue;
                    double ddx = x[node] - x[j];
                    double ddy = y[node] - y[j];
                    if (std::sqrt(ddx * ddx + ddy * ddy) < tol_spat)
                        out.push_back(j);
                }
            }
        }
        // index order, matching the Python np.where enumeration
        std::sort(out.begin(), out.end());
    };

    for (int64_t seed = 0; seed < n; ++seed) {
        if (matched[seed]) continue;
        matched[seed] = 1;
        stack.clear();
        stack.push_back(Frame{});
        candidates_of(seed, stack.back().cands);
        stack.back().pos = 0;
        while (!stack.empty()) {
            Frame& f = stack.back();
            if (f.pos >= f.cands.size()) { stack.pop_back(); continue; }
            int32_t candi = f.cands[f.pos++];
            if (matched[candi]) continue;
            double ddx = x[seed] - x[candi];
            double ddy = y[seed] - y[candi];
            double seed_dist = std::sqrt(ddx * ddx + ddy * ddy);
            if (seed_dist > sq2 && std::fabs(z[candi] - z[seed]) >= tol_spec)
                continue;
            matched[candi] = 1;
            imatch[candi] = seed;
            stack.push_back(Frame{});
            candidates_of(candi, stack.back().cands);
            stack.back().pos = 0;
        }
    }
    return 0;
}

}  // extern "C"
