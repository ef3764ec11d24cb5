// The multi-RHS band sweeps of a banded-arrowhead factor, each in one launch.
//
// Replaces the TPU kernels src/repro/kernels/band_solve.py::
// band_forward_sweep_pallas (body _band_forward_kernel) and
// band_backward_sweep_pallas (body _band_backward_kernel).
//
// Forward, inputs dr (ndt, bt+1, T, T) row-band factor tiles
// (dr[m, j] = L[m, m-j]), r (ndt, nat, T, T) arrow rows and the right-hand
// sides bd (ndt, T, k):
//   Y_m = L_mm^{-1} (B_m - sum_{j=1..bt} L[m, m-j] Y_{m-j}),  m = start..ndt-1
//   acc_a[i] = sum_m R[m, i] Y_m
// Backward, inputs lcol (ndt, bt+1, T, T) column view (lcol[m, j] =
// L[m+j, m]), r, yd (ndt, T, k) and the solved arrow panel xa (nat, T, k):
//   X_m = L_mm^{-T} (Y_m - sum_j L[m+j, m]^T X_{m+j} - sum_i R[m, i]^T Xa_i),
//   m = ndt-1..start
// Rows m < start (an identity prefix with zero right-hand side) are written
// as zeros and skipped.
//
// The columns of the right-hand side are independent, so each block takes
// kCols (32) of them and walks every row m in order: no block waits on
// another.  For each source tile of a row the block stages the factor tile
// (transposed where the product needs L^T) and the kCols-wide slice of the
// solved panel it multiplies in shared memory, the next pair's loads in
// flight during each product (panel_sum); warp w accumulates rows
// w, w + 8, ... of the update, lane c column c.  The update is then
// subtracted from the right-hand side and one warp solves the kCols columns
// against the diagonal tile, a column a lane (substitute_panel).  The
// solved panels the next rows read are this block's own outputs, already
// written to device memory, where they stay in L2: the TPU kernel's VMEM
// ring is not needed.  The forward sweep's arrow sums come after the walk,
// one accumulator per arrow tile, each written once.
//
// Bound on this card: bytes at small k.  Table II matrix 5 (ndt = 157,
// bt = 4, nat = 4, T = 64) has about 23 MB of factor tiles, which the card
// could read in 7 us; its products are about 2 T^2 k (bt + nat + 1/2)
// operations a row, 0.01 Gflop at k = 1 and 0.35 Gflop at k = 32.  This
// first design runs ceil(k / 32) blocks, one at k <= 32, so it is held to
// one SM: every block reads every factor tile and spends its time in the
// staging, the products and the T-step substitution of each row.
#include "tile.cuh"

namespace stiles {

constexpr int kCols = 32;   // right-hand-side columns a block owns: one warp's lanes

template <int T>
struct SolveTile {
    static constexpr int LD = Tile<T>::LDK;        // row of a staged factor tile
    static constexpr int kWarps = kThreads / 32;
    static constexpr int RPT = (T + kWarps - 1) / kWarps;  // rows a thread accumulates
};

// One thread's share of a factor tile and of the kCols-wide slice of a
// (T, k) panel on their way to shared memory: float4 v of the tile as in
// Stage, and Ys[l * kCols + c] = Y[l, c0 + c] (zero past column k).  Every
// load is issued before the first store, and panel_sum issues the next
// pair's loads before the current product.
template <int T>
struct PanelStage {
    static constexpr int kVec = T * T / 4, kPerA = (kVec + kThreads - 1) / kThreads;
    static constexpr int kPan = T * kCols, kPerY = (kPan + kThreads - 1) / kThreads;
    float4 a[kPerA];
    float y[kPerY];

    __device__ __forceinline__ void load(const float* A, const float* Y, int c0, int k) {
#pragma unroll
        for (int p = 0; p < kPerA; ++p) {
            const int v = threadIdx.x + p * kThreads;
            if (v < kVec) a[p] = *reinterpret_cast<const float4*>(A + (v % T) * T + 4 * (v / T));
        }
#pragma unroll
        for (int p = 0; p < kPerY; ++p) {
            const int idx = threadIdx.x + p * kThreads, c = c0 + idx % kCols;
            y[p] = idx < kPan && c < k ? Y[static_cast<size_t>(idx / kCols) * k + c] : 0.f;
        }
    }

    __device__ __forceinline__ void store(float* As, float* Ys, bool transpose) const {
#pragma unroll
        for (int p = 0; p < kPerA; ++p) {
            const int v = threadIdx.x + p * kThreads;
            if (v < kVec) Stage<T>::put(As, a[p], v, transpose);
        }
#pragma unroll
        for (int p = 0; p < kPerY; ++p) {
            const int idx = threadIdx.x + p * kThreads;
            if (idx < kPan) Ys[idx] = y[p];
        }
    }
};

// acc[r] += sum_l As[i_r, l] Ys[l, lane] for this thread's rows
// i_r = warp + 8 r: As is read as float4 broadcasts, Ys one word a lane.
template <int T>
__device__ __forceinline__ void panel_product(float (&acc)[SolveTile<T>::RPT], const float* As,
                                              const float* Ys) {
    constexpr int LD = SolveTile<T>::LD, RPT = SolveTile<T>::RPT, W = SolveTile<T>::kWarps;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 4
    for (int l = 0; l < T; l += 4) {
        const float y0 = Ys[l * kCols + lane], y1 = Ys[(l + 1) * kCols + lane];
        const float y2 = Ys[(l + 2) * kCols + lane], y3 = Ys[(l + 3) * kCols + lane];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int i = warp + W * r;
            if (i < T) {
                const float4 a = *reinterpret_cast<const float4*>(As + i * LD + l);
                acc[r] = fmaf(a.x, y0, fmaf(a.y, y1, fmaf(a.z, y2, fmaf(a.w, y3, acc[r]))));
            }
        }
    }
}

// acc += sum_{q < n} op(A(q)) Y(q)[:, c0 .. c0 + kCols): A(q) an Op (the
// factor tile, transposed where the product needs L^T), Y(q) a (T, k)
// panel.  The pattern of gemm_sum: the next pair's loads are in flight
// during each product; every thread calls it with the same n, and it
// synchronises the block twice per pair.
template <int T, typename FA, typename FY>
__device__ void panel_sum(float (&acc)[SolveTile<T>::RPT], int n, FA A, FY Y, float* As,
                          float* Ys, int c0, int k) {
    if (n <= 0) return;
    PanelStage<T> st;
    Op oa = A(0);
    st.load(oa.p, Y(0), c0, k);
    for (int q = 0; q < n; ++q) {
        __syncthreads();  // the staging buffers are free, the panels read are written
        st.store(As, Ys, oa.t);
        __syncthreads();
        if (q + 1 < n) {
            oa = A(q + 1);
            st.load(oa.p, Y(q + 1), c0, k);
        }
        panel_product<T>(acc, As, Ys);
    }
}

// Ys[i, lane] = B[i, c0 + lane] - acc[r] (rhs of the substitution), B a
// row-major (T, k) panel.
template <int T>
__device__ __forceinline__ void rhs_minus(float* Ys, const float* B, int c0, int k,
                                          const float (&acc)[SolveTile<T>::RPT]) {
    constexpr int RPT = SolveTile<T>::RPT, W = SolveTile<T>::kWarps;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = c0 + lane;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int i = warp + W * r;
        if (i < T) Ys[i * kCols + lane] = (c < k ? B[static_cast<size_t>(i) * k + c] : 0.f) - acc[r];
    }
}

// Warp 0 solves the kCols staged columns of Ys against the tile staged in
// As (substitute_panel's layout) and writes them to the (T, k) panel X.
template <int T, bool BACK>
__device__ __forceinline__ void solve_columns(float* X, const float* As, const float* Ys,
                                              int c0, int k) {
    const int c = c0 + threadIdx.x;
    if (threadIdx.x < 32 && c < k)
        solve_column<T, BACK>(As, SolveTile<T>::LD, Ys + threadIdx.x, kCols, X + c, k);
}

template <int T>
__device__ __forceinline__ void zero_columns(float* X, int c0, int k) {
    for (int idx = threadIdx.x; idx < T * kCols; idx += kThreads) {
        const int c = c0 + idx % kCols;
        if (c < k) X[static_cast<size_t>(idx / kCols) * k + c] = 0.f;
    }
}

template <int T>
__global__ void __launch_bounds__(kThreads, 1)
band_forward_kernel(const float* __restrict__ dr, const float* __restrict__ r_in,
                    const float* __restrict__ bd, float* yd, float* __restrict__ acca,
                    int ndt, int bt, int nat, int k, int start) {
    constexpr int LD = SolveTile<T>::LD, RPT = SolveTile<T>::RPT, W = SolveTile<T>::kWarps;
    constexpr size_t TT = static_cast<size_t>(T) * T;
    __shared__ __align__(16) float As[T * LD];
    __shared__ __align__(16) float Ys[T * kCols];
    const int c0 = blockIdx.x * kCols;
    // yd is written and read back by this block: plain (coherent) loads
    auto Y = [&](int m) { return yd + static_cast<size_t>(m) * T * k; };
    auto DR = [&](int m, int j) { return dr + (static_cast<size_t>(m) * (bt + 1) + j) * TT; };

    for (int m = 0; m < start; ++m) zero_columns<T>(Y(m), c0, k);
    for (int m = start; m < ndt; ++m) {
        float acc[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
        // L[m, m-j] Y_{m-j}; rows above start are zero, so j stops there
        __syncthreads();  // Y(m - 1) is written before its first load
        panel_sum<T>(acc, min(bt, m - start), [&](int q) { return Op{DR(m, q + 1), false}; },
                     [&](int q) { return Y(m - 1 - q); }, As, Ys, c0, k);
        __syncthreads();
        stage_tile<T>(As, DR(m, 0), true);   // S[j, i] = L_mm[i, j]
        rhs_minus<T>(Ys, bd + static_cast<size_t>(m) * T * k, c0, k, acc);
        __syncthreads();
        solve_columns<T, false>(Y(m), As, Ys, c0, k);
    }
    // arrow rows: acc_a[i] = sum_m R[m, i] Y_m
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = c0 + lane;
    for (int i = 0; i < nat; ++i) {
        float acc[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
        __syncthreads();  // every Y(m) is written
        panel_sum<T>(acc, ndt - start,
                     [&](int q) { return Op{r_in + (static_cast<size_t>(start + q) * nat + i) * TT,
                                            false}; },
                     [&](int q) { return Y(start + q); }, As, Ys, c0, k);
        float* out = acca + static_cast<size_t>(i) * T * k;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int row = warp + W * r;
            if (row < T && c < k) out[static_cast<size_t>(row) * k + c] = acc[r];
        }
    }
}

template <int T>
__global__ void __launch_bounds__(kThreads, 1)
band_backward_kernel(const float* __restrict__ lcol, const float* __restrict__ r_in,
                     const float* __restrict__ yd, const float* __restrict__ xa, float* xd,
                     int ndt, int bt, int nat, int k, int start) {
    constexpr int LD = SolveTile<T>::LD, RPT = SolveTile<T>::RPT;
    constexpr size_t TT = static_cast<size_t>(T) * T;
    __shared__ __align__(16) float As[T * LD];
    __shared__ __align__(16) float Ys[T * kCols];
    const int c0 = blockIdx.x * kCols;
    auto X = [&](int m) { return xd + static_cast<size_t>(m) * T * k; };
    auto LC = [&](int m, int j) { return lcol + (static_cast<size_t>(m) * (bt + 1) + j) * TT; };

    for (int m = ndt - 1; m >= start; --m) {
        float acc[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
        // L[m+j, m]^T X_{m+j} for j = 1..jmax, then R[m, i]^T Xa_i
        const int jmax = min(bt, ndt - 1 - m);
        __syncthreads();  // X(m + 1) is written before its first load
        panel_sum<T>(acc, jmax + nat,
                     [&](int q) {
                         return q < jmax ? Op{LC(m, q + 1), true}
                                         : Op{r_in + (static_cast<size_t>(m) * nat + q - jmax) * TT,
                                              true};
                     },
                     [&](int q) {
                         return q < jmax ? X(m + 1 + q)
                                         : xa + static_cast<size_t>(q - jmax) * T * k;
                     },
                     As, Ys, c0, k);
        __syncthreads();
        stage_tile<T>(As, LC(m, 0), false);  // S[j, i] = L_mm[j, i]
        rhs_minus<T>(Ys, yd + static_cast<size_t>(m) * T * k, c0, k, acc);
        __syncthreads();
        solve_columns<T, true>(X(m), As, Ys, c0, k);
    }
    for (int m = 0; m < start && m < ndt; ++m) zero_columns<T>(X(m), c0, k);
}

}  // namespace stiles

// dr (ndt, bt+1, t, t), r (ndt, nat, t, t), bd (ndt, t, k) -> yd (ndt, t, k),
// acca (nat, t, k); ndt >= 1, k >= 1.
extern "C" int stiles_band_forward_sweep_f32(const void* dr, const void* r, const void* bd,
                                             void* yd, void* acca, int ndt, int bt, int nat,
                                             int t, int k, int start, void* stream) {
    using namespace stiles;
    const auto* pd = static_cast<const float*>(dr);
    const auto* pr = static_cast<const float*>(r);
    const auto* pb = static_cast<const float*>(bd);
    auto* py = static_cast<float*>(yd);
    auto* pa = static_cast<float*>(acca);
    auto s = static_cast<cudaStream_t>(stream);
    const int nblk = (k + kCols - 1) / kCols;
    switch (t) {
        case 8: band_forward_kernel<8><<<nblk, kThreads, 0, s>>>(pd, pr, pb, py, pa, ndt, bt, nat, k, start); break;
        case 16: band_forward_kernel<16><<<nblk, kThreads, 0, s>>>(pd, pr, pb, py, pa, ndt, bt, nat, k, start); break;
        case 32: band_forward_kernel<32><<<nblk, kThreads, 0, s>>>(pd, pr, pb, py, pa, ndt, bt, nat, k, start); break;
        case 64: band_forward_kernel<64><<<nblk, kThreads, 0, s>>>(pd, pr, pb, py, pa, ndt, bt, nat, k, start); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// lcol (ndt, bt+1, t, t), r (ndt, nat, t, t), yd (ndt, t, k), xa (nat, t, k)
// -> xd (ndt, t, k); ndt >= 1, k >= 1.
extern "C" int stiles_band_backward_sweep_f32(const void* lcol, const void* r, const void* yd,
                                              const void* xa, void* xd, int ndt, int bt,
                                              int nat, int t, int k, int start, void* stream) {
    using namespace stiles;
    const auto* pl = static_cast<const float*>(lcol);
    const auto* pr = static_cast<const float*>(r);
    const auto* py = static_cast<const float*>(yd);
    const auto* pa = static_cast<const float*>(xa);
    auto* px = static_cast<float*>(xd);
    auto s = static_cast<cudaStream_t>(stream);
    const int nblk = (k + kCols - 1) / kCols;
    switch (t) {
        case 8: band_backward_kernel<8><<<nblk, kThreads, 0, s>>>(pl, pr, py, pa, px, ndt, bt, nat, k, start); break;
        case 16: band_backward_kernel<16><<<nblk, kThreads, 0, s>>>(pl, pr, py, pa, px, ndt, bt, nat, k, start); break;
        case 32: band_backward_kernel<32><<<nblk, kThreads, 0, s>>>(pl, pr, py, pa, px, ndt, bt, nat, k, start); break;
        case 64: band_backward_kernel<64><<<nblk, kThreads, 0, s>>>(pl, pr, py, pa, px, ndt, bt, nat, k, start); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
