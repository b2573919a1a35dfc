// Native staging engine: host-side data plane for the transcode farm.
//
// The device launches want lane-major int32 buffers (rows = input frames, lanes =
// stream x channel), while audio arrives stream-major interleaved s16 — the
// same impedance the reference's high-level layer solves with its staging
// buffer + memmove halo (clownresampler.h:1143-1154), scaled to thousands of
// streams. These loops are the per-chunk host hot path, so they are C++ with
// threads rather than numpy transposes.
//
// Exposed via ctypes (clownresampler_tpu/utils/native.py); every function has
// a numpy fallback and is differentially tested against it.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

long clamp_threads(long work_items) {
    long hw = static_cast<long>(std::thread::hardware_concurrency());
    if (hw < 1) hw = 1;
    if (hw > work_items) hw = work_items;
    return hw;
}

template <typename F>
void parallel_for(long count, F body) {
    const long n_threads = clamp_threads(count);
    if (n_threads <= 1) {
        for (long i = 0; i < count; ++i) body(i);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    const long per = (count + n_threads - 1) / n_threads;
    for (long t = 0; t < n_threads; ++t) {
        const long lo = t * per;
        const long hi = std::min(count, lo + per);
        if (lo >= hi) break;
        threads.emplace_back([=] {
            for (long i = lo; i < hi; ++i) body(i);
        });
    }
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// (B, n, C) interleaved s16 -> rows [row_off, row_off+n) of a lane-major
// (S, ld_out) int32 staging buffer: out[row_off+r][b*C + c] = in[b][r][c].
// Cache-blocked transpose (64x64 stream/row tiles), threads over row blocks:
// within a tile the source is contiguous per stream and the destination
// rows stay resident, ~5x faster than the naive stream-major loop.
void stage_i16_to_i32_lanes(const int16_t* in, int32_t* out, long B, long n,
                            long C, long ld_out, long row_off) {
    const long RB = 64, BB = 64;
    const long n_row_blocks = (n + RB - 1) / RB;
    parallel_for(n_row_blocks, [=](long rb) {
        const long r0 = rb * RB;
        const long r1 = std::min(n, r0 + RB);
        for (long b0 = 0; b0 < B; b0 += BB) {
            const long b1 = std::min(B, b0 + BB);
            for (long b = b0; b < b1; ++b) {
                const int16_t* src = in + (b * n + r0) * C;
                int32_t* dst = out + (row_off + r0) * ld_out + b * C;
                for (long r = r0; r < r1; ++r) {
                    for (long c = 0; c < C; ++c) dst[c] = static_cast<int32_t>(src[c]);
                    src += C;
                    dst += ld_out;
                }
            }
        }
    });
}

// Zero rows [row_off, row_off+n) of the staging buffer.
void zero_rows_i32(int32_t* buf, long ld, long row_off, long n) {
    std::memset(buf + row_off * ld, 0, static_cast<size_t>(n) * ld * sizeof(int32_t));
}

// Slide the staging window left: buf[r] = buf[r + shift] for r < rows_keep.
void shift_rows_i32(int32_t* buf, long rows_keep, long ld, long shift) {
    std::memmove(buf, buf + shift * ld,
                 static_cast<size_t>(rows_keep) * ld * sizeof(int32_t));
}

// Lane-major kernel output (m, ld_in) -> per-stream (B, m, C) int32.
// Same blocking as stage_i16_to_i32_lanes, transposed direction.
void unstage_i32_to_streams(const int32_t* in, int32_t* out, long B, long m,
                            long C, long ld_in) {
    const long RB = 64, BB = 64;
    const long n_row_blocks = (m + RB - 1) / RB;
    parallel_for(n_row_blocks, [=](long rb) {
        const long r0 = rb * RB;
        const long r1 = std::min(m, r0 + RB);
        for (long b0 = 0; b0 < B; b0 += BB) {
            const long b1 = std::min(B, b0 + BB);
            for (long b = b0; b < b1; ++b) {
                const int32_t* src = in + r0 * ld_in + b * C;
                int32_t* dst = out + (b * m + r0) * C;
                for (long r = r0; r < r1; ++r) {
                    for (long c = 0; c < C; ++c) dst[c] = src[c];
                    src += ld_in;
                    dst += C;
                }
            }
        }
    });
}

}  // extern "C"
