// Multi-RHS triangular panel solve for a batch of panels: out[b] = L^{-1} B[b]
// (trans = 0) or L^{-T} B[b] (trans = 1), B[b] a row-major (T, k) panel,
// with one L for the whole batch or one L for each panel (L[b], the batched
// corner of the θ-batch's solves: each candidate its own corner tile).  A
// panel's L is L[b / per_l], per_l the panels that share one (nb, or 1), so
// the L is the only thing that differs between the two forms: panel b of a
// launch with one L a panel is written bit for bit as a launch of that panel
// alone against its L.
//
// Replaces the TPU kernel src/repro/kernels/trsm.py::solve_panel_pallas
// (body _solve_panel_kernel -> substitute_panel).
//
// Bound on this card: a panel is T^2 + 2 T k floats moved for T^2 k
// operations, so at the corner's shapes (T = 64, k <= 64) the bytes bound it
// at tens of nanoseconds, and neither bound is close: each column is a chain
// of T dependent divisions and updates, and what a call costs is the launch,
// the first loads and that chain.  The first design gave a thread a whole
// column (64 divisions and some 2,000 dependent FMAs in registers) and a
// block 64 columns, so at k = 32 one warp on one SM did all of it.
//
// The design.  The grid is one block for each panel and each chunk of R
// columns (R = 1, 2, 4 or 8; kernels/trsm.py::solve_panel_chunk picks 1
// while every column's block fits on the card at once, else 8), so the
// columns spread over SMs; a ragged last chunk is padded with zero
// columns, whose solution is zero and is not stored.  The block holds its
// chunk transposed in shared memory, a row of X one right-hand-side column,
// and solves it with tile.cuh's blocked solve_few_rows (both directions): a
// panel of 16 rows is one pass of a thread a column, then the update of
// the rows it feeds spread over the whole block, one barrier after each (7
// at T = 64).  L is copied into shared memory by 16-byte cp.async in the
// row-major layout solve_few_rows reads, while the chunk's columns load (as
// float4 along a row where k % 4 == 0 and R >= 4, by 4-byte cp.async
// otherwise); the pivots' reciprocals are computed once a block after one
// barrier, so the chain multiplies.  No column's sum crosses blocks and
// each element is updated in the same order whatever R is, so every chunk
// width gives the same bits.
#include "tile_sum.cuh"

namespace stiles {

constexpr int kPanelThreads = 128;

// Columns c0 .. c0 + R - 1 of the row-major (T, k) panel src into X
// transposed, X[c * (T + 4) + i] = src[i, c0 + c], zero past column k.
// Issues cp.async copies in the scalar case; the caller commits and waits.
template <int T, int R>
__device__ __forceinline__ void stage_columns(float* X, const float* src, int c0, int k,
                                              bool vec) {
    constexpr int LD = T + 4;
    if constexpr (R >= 4) {
        if (vec) {   // k % 4 == 0, so a float4 is whole inside or past k
            constexpr int Q = R / 4;
            for (int v = threadIdx.x; v < T * Q; v += kPanelThreads) {
                const int i = v / Q, c = 4 * (v % Q);
                float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
                if (c0 + c < k)
                    x = __ldg(reinterpret_cast<const float4*>(
                        src + static_cast<size_t>(i) * k + c0 + c));
                X[c * LD + i] = x.x;
                X[(c + 1) * LD + i] = x.y;
                X[(c + 2) * LD + i] = x.z;
                X[(c + 3) * LD + i] = x.w;
            }
            return;
        }
    }
    for (int v = threadIdx.x; v < T * R; v += kPanelThreads) {
        const int i = v / R, c = v % R;
        if (c0 + c < k)
            cp_async4(X + c * LD + i, src + static_cast<size_t>(i) * k + c0 + c);
        else
            X[c * LD + i] = 0.f;
    }
}

// The chunk's solved columns from X back into the panel dst.
template <int T, int R>
__device__ __forceinline__ void store_columns(float* dst, const float* X, int c0, int k,
                                              bool vec) {
    constexpr int LD = T + 4;
    if constexpr (R >= 4) {
        if (vec) {
            constexpr int Q = R / 4;
            for (int v = threadIdx.x; v < T * Q; v += kPanelThreads) {
                const int i = v / Q, c = 4 * (v % Q);
                if (c0 + c < k)
                    *reinterpret_cast<float4*>(dst + static_cast<size_t>(i) * k + c0 + c) =
                        make_float4(X[c * LD + i], X[(c + 1) * LD + i], X[(c + 2) * LD + i],
                                    X[(c + 3) * LD + i]);
            }
            return;
        }
    }
    for (int v = threadIdx.x; v < T * R; v += kPanelThreads) {
        const int i = v / R, c = v % R;
        if (c0 + c < k) dst[static_cast<size_t>(i) * k + c0 + c] = X[c * LD + i];
    }
}

// Block x solves chunk x % chunks of panel x / chunks, against L number
// (x / chunks) / per_l.
template <int T, int R, bool BACK>
__global__ void __launch_bounds__(kPanelThreads)
solve_panel_kernel(const float* __restrict__ l, const float* __restrict__ b,
                   float* __restrict__ out, int k, int chunks, int per_l, int vec) {
    constexpr int LD = T + 4, C4 = T / 4;
    __shared__ __align__(16) float L[T * LD];
    __shared__ __align__(16) float X[R * LD];
    __shared__ float dinv[T];
    const unsigned panel = blockIdx.x / chunks;
    l += static_cast<size_t>(panel / per_l) * T * T;
    for (int v = threadIdx.x; v < T * C4; v += kPanelThreads)
        cp_async16(L + (v / C4) * LD + 4 * (v % C4), l + 4 * v);
    const size_t off = static_cast<size_t>(panel) * T * k;
    const int c0 = static_cast<int>(blockIdx.x % chunks) * R;
    stage_columns<T, R>(X, b + off, c0, k, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (threadIdx.x < T) dinv[threadIdx.x] = __frcp_rn(L[threadIdx.x * (LD + 1)]);
    __syncthreads();
    solve_few_rows<T, kPanelThreads, R, BACK>(X, LD, L, LD, dinv);
    store_columns<T, R>(out + off, X, c0, k, vec);
}

template <int T, int R>
int launch_solve_panel(const float* l, const float* b, float* out, int nb, int k, int per_l,
                       int trans, int vec, cudaStream_t s) {
    const int chunks = (k + R - 1) / R;
    const long long blocks = static_cast<long long>(nb) * chunks;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks));
    if (trans)
        solve_panel_kernel<T, R, true><<<grid, kPanelThreads, 0, s>>>(l, b, out, k, chunks, per_l,
                                                                      vec);
    else
        solve_panel_kernel<T, R, false><<<grid, kPanelThreads, 0, s>>>(l, b, out, k, chunks, per_l,
                                                                       vec);
    return static_cast<int>(cudaGetLastError());
}

template <int T>
int launch_solve_panel_t(const float* l, const float* b, float* out, int nb, int k, int chunk,
                         int per_l, int trans, int vec, cudaStream_t s) {
    switch (chunk) {
        case 1: return launch_solve_panel<T, 1>(l, b, out, nb, k, per_l, trans, vec, s);
        case 2: return launch_solve_panel<T, 2>(l, b, out, nb, k, per_l, trans, vec, s);
        case 4: return launch_solve_panel<T, 4>(l, b, out, nb, k, per_l, trans, vec, s);
        case 8: return launch_solve_panel<T, 8>(l, b, out, nb, k, per_l, trans, vec, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace stiles

// l is 16-byte aligned (nb / per_l, t, t) tiles, one for every per_l panels
// (per_l = nb: one L for every panel; 1: one L a panel); b and out are
// (nb, t, k), k >= 1, solved in chunks of `chunk` columns (1, 2, 4 or 8);
// vec: k % 4 == 0 and b, out 16-byte aligned.
extern "C" int stiles_solve_panel_f32(const void* l, const void* b, void* out, int nb, int t,
                                      int k, int chunk, int per_l, int trans, int vec,
                                      void* stream) {
    using namespace stiles;
    if (per_l < 1 || nb % per_l) return static_cast<int>(cudaErrorInvalidValue);
    const auto* pl = static_cast<const float*>(l);
    const auto* pb = static_cast<const float*>(b);
    auto* po = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (t) {
        case 8: return launch_solve_panel_t<8>(pl, pb, po, nb, k, chunk, per_l, trans, vec, s);
        case 16: return launch_solve_panel_t<16>(pl, pb, po, nb, k, chunk, per_l, trans, vec, s);
        case 32: return launch_solve_panel_t<32>(pl, pb, po, nb, k, chunk, per_l, trans, vec, s);
        case 64: return launch_solve_panel_t<64>(pl, pb, po, nb, k, chunk, per_l, trans, vec, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
