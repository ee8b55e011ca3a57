// Native bond perception for host-side molecule ingestion.
//
// Replaces the Python cell-list loop in chem/mol.py (the reference does
// this in C++ inside OpenBabel / model::assign_bonds, model.cpp:560).
// Receptor-scale proteins (~10^4 atoms) take seconds in pure Python and
// ~1 ms here; the host feeder must keep up with the accelerator during
// virtual screens.
//
// Exposed as a tiny C ABI consumed via ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

struct CellKey {
    int64_t x, y, z;
    bool operator==(const CellKey &o) const {
        return x == o.x && y == o.y && z == o.z;
    }
};

struct CellKeyHash {
    size_t operator()(const CellKey &k) const {
        return static_cast<size_t>(k.x * 73856093LL ^ k.y * 19349663LL ^
                                   k.z * 83492791LL);
    }
};

}  // namespace

extern "C" {

// coords: n x 3 float32; radii: n float32 covalent radii; anum: n int32.
// out_pairs: preallocated (max_pairs x 2) int32. Returns #pairs found
// (clamped to max_pairs), or -1 on error.
int perceive_bonds(const float *coords, const float *radii,
                   const int32_t *anum, int n, float tolerance,
                   int32_t *out_pairs, int max_pairs) {
    if (n <= 0) return 0;
    float max_r = 0.0f;
    for (int i = 0; i < n; ++i)
        if (radii[i] > max_r) max_r = radii[i];
    const float cell = 2.0f * max_r + tolerance;
    if (!(cell > 0.0f)) return -1;

    std::unordered_map<CellKey, std::vector<int>, CellKeyHash> grid;
    grid.reserve(static_cast<size_t>(n));
    auto key_of = [&](int i) {
        return CellKey{static_cast<int64_t>(std::floor(coords[3 * i] / cell)),
                       static_cast<int64_t>(std::floor(coords[3 * i + 1] / cell)),
                       static_cast<int64_t>(std::floor(coords[3 * i + 2] / cell))};
    };
    for (int i = 0; i < n; ++i) grid[key_of(i)].push_back(i);

    int count = 0;
    for (int i = 0; i < n; ++i) {
        const CellKey k = key_of(i);
        for (int64_t dx = -1; dx <= 1; ++dx)
            for (int64_t dy = -1; dy <= 1; ++dy)
                for (int64_t dz = -1; dz <= 1; ++dz) {
                    auto it = grid.find(CellKey{k.x + dx, k.y + dy, k.z + dz});
                    if (it == grid.end()) continue;
                    for (int j : it->second) {
                        if (j <= i) continue;
                        if (anum[i] == 1 && anum[j] == 1) continue;
                        const float ax = coords[3 * i] - coords[3 * j];
                        const float ay = coords[3 * i + 1] - coords[3 * j + 1];
                        const float az = coords[3 * i + 2] - coords[3 * j + 2];
                        const float d2 = ax * ax + ay * ay + az * az;
                        const float lim = radii[i] + radii[j] + tolerance;
                        if (d2 < lim * lim && d2 > 0.16f) {
                            if (count < max_pairs) {
                                out_pairs[2 * count] = i;
                                out_pairs[2 * count + 1] = j;
                            }
                            ++count;
                        }
                    }
                }
    }
    return count > max_pairs ? max_pairs : count;
}

}  // extern "C"
