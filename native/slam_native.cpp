// Native host-side runtime for slam_tpu.
//
// The reference implements its entire runtime in C++ (pthread fan-outs in
// `slam/mcl.cpp:108-144`, scalar DDA raycast in `slam/raycast.cpp:8-141`,
// OpenCV erode preambles in the apps). The accelerator compute path here is
// JAX/XLA, but the host-side pieces that feed and check it stay native:
//
//   * rc_raycast_batch  — multithreaded exact-reference-semantics DDA
//     raycast over a uint8 occupancy grid. Used as (a) the host sensor
//     simulator feeding scan streams without occupying the device, and
//     (b) the fast oracle the JAX backends are tested against.
//   * rc_scan_poses     — bulk lidar simulation for a whole trajectory
//     (T poses x B beams) across hardware threads.
//   * em_erode_disc     — binary disc erosion (vehicle inflation,
//     `apps/hastar_planner.cpp:130-134` equivalent) via per-row sliding
//     minima + chord AND; O(H*W*r) with tiny constants.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).
// Build: native/build.sh -> .build/libslam_native.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace
{

// Reference DDA semantics (`slam/raycast.cpp:8-51`): sample positions
// p_k = origin + k*step*dir (k = 1..), skip cells equal to the previously
// tested cell, first blocked cell -> hit at distance k*step; out-of-bounds
// or distance >= max_dist -> miss (reported as max_dist, hit=0).
inline void raycast_one(const uint8_t* blocked,
                        int h,
                        int w,
                        float x,
                        float y,
                        float theta,
                        float step,
                        float max_dist,
                        float* out_dist,
                        uint8_t* out_hit)
{
    const float dx = std::cos(theta) * step;
    const float dy = std::sin(theta) * step;
    const int i0 = static_cast<int>(std::floor(h - y - 1.0f));
    const int j0 = static_cast<int>(std::floor(x));
    long prev = static_cast<long>(i0) * w + j0;

    // p_k computed multiplicatively (origin + k*step*dir) so results match
    // the vectorized backends bit-for-bit; additive accumulation drifts
    // across cell boundaries on long rays.
    float d = 0.0f;
    for (long k = 1;; ++k)
    {
        const float px = x + dx * static_cast<float>(k);
        const float py = y + dy * static_cast<float>(k);
        d = step * static_cast<float>(k);
        if (d >= max_dist) break;
        const int i = static_cast<int>(std::floor(h - py - 1.0f));
        const int j = static_cast<int>(std::floor(px));
        if (i < 0 || i >= h || j < 0 || j >= w) break;
        const long cell = static_cast<long>(i) * w + j;
        if (cell == prev) continue;
        prev = cell;
        if (blocked[cell])
        {
            *out_dist = d;
            *out_hit = 1;
            return;
        }
    }
    *out_dist = max_dist;
    *out_hit = 0;
}

void parallel_for(long n, const std::function<void(long, long)>& fn)
{
    const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    const long chunk = (n + hw - 1) / hw;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < hw; ++t)
    {
        const long lo = t * chunk;
        const long hi = std::min<long>(n, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(fn, lo, hi);
    }
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C"
{

// blocked: u8[h*w] (1 = blocked). x/y/theta: f32[n]. out_dist: f32[n],
// out_hit: u8[n].
void rc_raycast_batch(const uint8_t* blocked,
                      int h,
                      int w,
                      const float* x,
                      const float* y,
                      const float* theta,
                      long n,
                      float step,
                      float max_dist,
                      float* out_dist,
                      uint8_t* out_hit)
{
    parallel_for(n,
                 [&](long lo, long hi)
                 {
                     for (long k = lo; k < hi; ++k)
                         raycast_one(blocked, h, w, x[k], y[k], theta[k], step,
                                     max_dist, &out_dist[k], &out_hit[k]);
                 });
}

// Simulate a lidar for T poses x B beams: pose arrays f32[t_count], beam
// angle offsets f32[beams]; outputs f32[t_count*beams] / u8[t_count*beams].
void rc_scan_poses(const uint8_t* blocked,
                   int h,
                   int w,
                   const float* px,
                   const float* py,
                   const float* ptheta,
                   long t_count,
                   const float* beam_angles,
                   int beams,
                   float step,
                   float max_dist,
                   float* out_dist,
                   uint8_t* out_hit)
{
    parallel_for(t_count * beams,
                 [&](long lo, long hi)
                 {
                     for (long k = lo; k < hi; ++k)
                     {
                         const long t = k / beams;
                         const int b = static_cast<int>(k % beams);
                         raycast_one(blocked, h, w, px[t], py[t],
                                     ptheta[t] + beam_angles[b], step, max_dist,
                                     &out_dist[k], &out_hit[k]);
                     }
                 });
}

// Binary disc erosion: out[i,j] = 1 iff every in-cell within `radius` is 1.
// in/out: u8[h*w]. Decomposed into per-row sliding minima over the disc
// chord at each |dy|, then a vertical AND.
void em_erode_disc(const uint8_t* in, int h, int w, int radius, uint8_t* out)
{
    if (radius <= 0)
    {
        std::memcpy(out, in, static_cast<size_t>(h) * w);
        return;
    }
    // Chord half-widths per |dy|.
    std::vector<int> half(radius + 1);
    for (int dy = 0; dy <= radius; ++dy)
        half[dy] = static_cast<int>(std::floor(
            std::sqrt(static_cast<double>(radius) * radius - static_cast<double>(dy) * dy)));

    // row_min[r][j] = min over the chord window of row r for each needed
    // half-width. Precompute per distinct half-width value.
    std::vector<int> widths(half);
    std::sort(widths.begin(), widths.end());
    widths.erase(std::unique(widths.begin(), widths.end()), widths.end());

    // eroded_rows[widx][r*w + j]
    std::vector<std::vector<uint8_t>> eroded_rows(widths.size());
    for (size_t wi = 0; wi < widths.size(); ++wi)
    {
        eroded_rows[wi].resize(static_cast<size_t>(h) * w);
        const int hw_ = widths[wi];
        uint8_t* dst = eroded_rows[wi].data();
        parallel_for(h,
                     [&, hw_, dst](long lo, long hi)
                     {
                         for (long r = lo; r < hi; ++r)
                         {
                             const uint8_t* row = in + r * w;
                             uint8_t* orow = dst + r * w;
                             for (int j = 0; j < w; ++j)
                             {
                                 uint8_t v = 1;
                                 const int a = std::max(0, j - hw_);
                                 const int b = std::min(w - 1, j + hw_);
                                 if (j - hw_ < 0 || j + hw_ > w - 1) v = 0;  // border
                                 for (int q = a; q <= b && v; ++q) v &= row[q];
                                 orow[j] = v;
                             }
                         }
                     });
    }

    auto widx_of = [&](int hw_) {
        return std::lower_bound(widths.begin(), widths.end(), hw_) - widths.begin();
    };

    parallel_for(h,
                 [&](long lo, long hi)
                 {
                     for (long i = lo; i < hi; ++i)
                     {
                         uint8_t* orow = out + i * w;
                         std::fill(orow, orow + w, 1);
                         for (int dy = -radius; dy <= radius; ++dy)
                         {
                             const long r = i + dy;
                             if (r < 0 || r >= h)
                             {
                                 std::fill(orow, orow + w, 0);
                                 break;
                             }
                             const uint8_t* er =
                                 eroded_rows[widx_of(half[std::abs(dy)])].data() + r * w;
                             for (int j = 0; j < w; ++j) orow[j] &= er[j];
                         }
                     }
                 });
}

int rc_hardware_threads() { return static_cast<int>(std::thread::hardware_concurrency()); }

}  // extern "C"
