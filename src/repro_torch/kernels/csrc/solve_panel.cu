// Multi-RHS triangular panel solve for a batch of panels: out[b] = L^{-1} B[b]
// (trans = 0) or L^{-T} B[b] (trans = 1), B[b] a row-major (T, k) panel,
// with one L for the whole batch.
//
// Replaces the TPU kernel src/repro/kernels/trsm.py::solve_panel_pallas
// (body _solve_panel_kernel -> substitute_panel).
//
// Bound on this card: a panel is T^2 + 2 T k floats moved for T^2 k
// operations, so at the corner's shapes (T = 64, k <= 64) the bytes bound it
// at tens of nanoseconds, and neither bound is close: each column is a chain
// of T dependent divisions and updates.  The design gives each block one
// panel and kPanelCols of its columns, L staged once in shared memory in the
// layout substitute_panel reads, and each thread one column in registers;
// any k works, the last chunk of columns is ragged.
#include "tile.cuh"

namespace stiles {

constexpr int kPanelCols = 64;

template <int T, bool BACK>
__global__ void __launch_bounds__(kPanelCols)
solve_panel_kernel(const float* __restrict__ l, const float* __restrict__ b,
                   float* __restrict__ out, int k) {
    constexpr int LD = T + 4;
    __shared__ __align__(16) float S[T * LD];
    // forward: S[c, r] = L[r, c]; backward: S[r, c] = L[r, c]
    for (int idx = threadIdx.x; idx < T * T; idx += kPanelCols) {
        const int r = idx / T, c = idx % T;
        S[BACK ? r * LD + c : c * LD + r] = l[idx];
    }
    __syncthreads();
    const int col = blockIdx.y * kPanelCols + threadIdx.x;
    if (col >= k) return;
    const size_t off = static_cast<size_t>(blockIdx.x) * T * k + col;
    float x[T];
#pragma unroll
    for (int r = 0; r < T; ++r) x[r] = b[off + static_cast<size_t>(r) * k];
    substitute_panel<T, BACK>(S, LD, x);
#pragma unroll
    for (int r = 0; r < T; ++r) out[off + static_cast<size_t>(r) * k] = x[r];
}

template <int T>
int launch_solve_panel(const float* l, const float* b, float* out, int nb, int k, int trans,
                       cudaStream_t s) {
    const dim3 grid(nb, (k + kPanelCols - 1) / kPanelCols);
    if (trans)
        solve_panel_kernel<T, true><<<grid, kPanelCols, 0, s>>>(l, b, out, k);
    else
        solve_panel_kernel<T, false><<<grid, kPanelCols, 0, s>>>(l, b, out, k);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace stiles

// l is one (t, t) tile for every panel; b and out are (nb, t, k); k >= 1.
extern "C" int stiles_solve_panel_f32(const void* l, const void* b, void* out, int nb, int t,
                                      int k, int trans, void* stream) {
    using namespace stiles;
    const auto* pl = static_cast<const float*>(l);
    const auto* pb = static_cast<const float*>(b);
    auto* po = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (t) {
        case 8: return launch_solve_panel<8>(pl, pb, po, nb, k, trans, s);
        case 16: return launch_solve_panel<16>(pl, pb, po, nb, k, trans, s);
        case 32: return launch_solve_panel<32>(pl, pb, po, nb, k, trans, s);
        case 64: return launch_solve_panel<64>(pl, pb, po, nb, k, trans, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
