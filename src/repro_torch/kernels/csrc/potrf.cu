// Cholesky of a batch of SPD tiles: out[b] = L with a[b] = L L^T.
//
// Replaces the TPU kernel src/repro/kernels/potrf.py::potrf_pallas (body
// _potrf_kernel -> factorize_tile).
//
// Bound on this card: a tile is 2 T^2 floats moved for T^3 / 3 operations
// (32 KB and 87 kflop at T = 64), so the bytes bound it at a few ns, and
// neither bound is close: a factorization is a chain of dependent steps,
// so one tile's time is latency.  The first design (tile.cuh's
// factorize_tile, still used inside the band-Cholesky sweeps) ran a T-step
// column loop with two block barriers a column, 128 at T = 64.  This one
// is blocked, so its barriers do not grow with T:
//   - the tile sits in shared memory, rows padded to T + 1 floats;
//   - it is walked in panels of NB = min(T, 16) columns.  For each panel:
//     (a) the NB x NB diagonal block is factored by a warp, lane i holding
//         row i in registers, the pivot and each scaled column entry
//         broadcast by __shfl_sync: no block barrier inside;
//     (b) the rows below it (X L11^T = A21) ride along in the same loop:
//         lanes 16..31 of warp w hold rows 16 w .. 16 w + 15 below the
//         block, and every warp factors the block alike to have its
//         broadcasts, so the panel is one pass of NB steps;
//     (c) the block updates the trailing lower triangle, A22 -= L21 L21^T,
//         a thread a 4 x 4 micro-tile;
//     with one barrier after (a, b) and one after (c): 8 barriers at T = 64
//     (load, two a panel for the first three panels, one for the last).
// Arithmetic is plain fp32 FMA (no TF32), the pivot's reciprocal square
// root by rsqrtf, as the TPU kernel's rsqrt.  A non-positive pivot gives
// NaN (rsqrt of a negative number, or 0 * inf), which then reaches every
// later column through the updates.  out may be a:
// the whole tile is read into shared memory before anything is written.
// One block a tile of the batch.
#include "tile.cuh"

namespace stiles {

template <int T>
struct PotrfShape {
    static constexpr int NB = T < 16 ? T : 16;                   // panel width
    static constexpr int LD = T + 1;                             // padded row
    static constexpr int THREADS = T == 64 ? 256 : T == 32 ? 128 : 32;
};

template <int T>
__global__ void __launch_bounds__(PotrfShape<T>::THREADS)
potrf_kernel(const float* a, float* out) {  // out may be a: see above
    using Sh = PotrfShape<T>;
    constexpr int NB = Sh::NB, LD = Sh::LD, NT = Sh::THREADS;
    __shared__ float S[T * LD];
    const size_t off = static_cast<size_t>(blockIdx.x) * T * T;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    for (int v = tid; v < T * T / 4; v += NT) {
        const float4 x = reinterpret_cast<const float4*>(a + off)[v];
        float* row = S + (4 * v / T) * LD + 4 * v % T;
        row[0] = x.x; row[1] = x.y; row[2] = x.z; row[3] = x.w;
    }
    __syncthreads();

#pragma unroll 1
    for (int k0 = 0; k0 < T; k0 += NB) {
        const int k1 = k0 + NB;
        // (a, b) the panel: warp w's lanes 0..NB-1 hold the diagonal block's
        // rows and lanes 16..31 rows k1 + 16 w + 0..15 below it; every warp
        // factors the diagonal block alike and solves its own rows with it
        const int below = lane - 16 + 16 * warp;           // row k1 + below
        const bool diag_row = lane < NB;
        const bool below_row = lane >= 16 && k1 + below < T;
        if (warp == 0 || 16 * warp < T - k1) {
            const int row = diag_row ? k0 + lane : k1 + below;
            float r[NB];
#pragma unroll
            for (int c = 0; c < NB; ++c)
                r[c] = diag_row || below_row ? S[row * LD + k0 + c] : 0.f;
            const int i = diag_row ? lane : NB;            // the row's place in the panel
#pragma unroll
            for (int k = 0; k < NB; ++k) {
                const float dinv = rsqrtf(__shfl_sync(0xffffffffu, r[k], k));
                const float lk = r[k] * dinv;              // L[row, k] for i >= k
                r[k] = i >= k ? lk : r[k];
#pragma unroll
                for (int m = k + 1; m < NB; ++m) {
                    const float lmk = __shfl_sync(0xffffffffu, lk, m);
                    // selects, not branches (see tile.cuh::factorize_tile)
                    r[m] = i >= m ? fmaf(-lk, lmk, r[m]) : r[m];
                }
            }
            if ((diag_row && warp == 0) || below_row) {
#pragma unroll
                for (int c = 0; c < NB; ++c)
                    if (c <= i) S[row * LD + k0 + c] = r[c];
            }
        }
        __syncthreads();
        if (k1 == T) break;
        // (c) the trailing lower triangle: A22 -= L21 L21^T, 4 x 4 micro-tiles
        const int nmb = (T - k1) / 4;
        for (int idx = tid; idx < nmb * nmb; idx += NT) {
            const int bi = idx / nmb, bm = idx % nmb;
            if (bm > bi) continue;
            const int i0 = k1 + 4 * bi, m0 = k1 + 4 * bm;
            float acc[4][4];
#pragma unroll
            for (int p = 0; p < 4; ++p)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[p][q] = S[(i0 + p) * LD + m0 + q];
#pragma unroll
            for (int c = 0; c < NB; ++c) {
                float li[4], lm[4];
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                    li[p] = S[(i0 + p) * LD + k0 + c];
                    lm[p] = S[(m0 + p) * LD + k0 + c];
                }
#pragma unroll
                for (int p = 0; p < 4; ++p)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(-li[p], lm[q], acc[p][q]);
            }
#pragma unroll
            for (int p = 0; p < 4; ++p)
#pragma unroll
                for (int q = 0; q < 4; ++q) S[(i0 + p) * LD + m0 + q] = acc[p][q];
        }
        __syncthreads();
    }

    for (int v = tid; v < T * T; v += NT) {
        const int r = v / T, c = v % T;
        out[off + v] = c <= r ? S[r * LD + c] : 0.f;
    }
}

template <int T>
cudaError_t launch_potrf(const float* a, float* out, int nb, cudaStream_t s) {
    potrf_kernel<T><<<nb, PotrfShape<T>::THREADS, 0, s>>>(a, out);
    return cudaGetLastError();
}

}  // namespace stiles

extern "C" int stiles_potrf_f32(const void* a, void* out, int nb, int t, void* stream) {
    using namespace stiles;
    const auto* pa = static_cast<const float*>(a);
    auto* po = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (t) {
        case 8: return static_cast<int>(launch_potrf<8>(pa, po, nb, s));
        case 16: return static_cast<int>(launch_potrf<16>(pa, po, nb, s));
        case 32: return static_cast<int>(launch_potrf<32>(pa, po, nb, s));
        case 64: return static_cast<int>(launch_potrf<64>(pa, po, nb, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
