// One Takahashi tile step of the selected inversion: for the Sigma block row
// visible from a column, s_row (e_n, j_n, T, T), and the normalized factor
// column g_col (j_n, T, T), G[k] = L[k, j] L[j, j]^{-1},
//   u[e] = sum_q s_row[e, q] g_col[q]        e = 0..e_n-1,
// the accumulation chain that feeds one column of Sigma = A^{-1}
// (ref.selinv_sweep_ref negates it into the column's off-diagonal tiles).
//
// Replaces the TPU kernel src/repro/kernels/selinv.py::selinv_step_pallas
// (body _selinv_step_kernel), the standalone tile primitive of
// ops.selinv_step; the whole recurrence is selinv.cu.
//
// Grid e_n: block e accumulates u[e] in plain FP32 FMAs (no TF32) through
// tile.cuh's gemm_sum, the pairs q = 0..j_n-1 in order.  It is an NN
// product: s_row[e, q] is staged transposed and g_col[q] as it is (the
// per-operand transpose flag of gemm_sum), so neither operand is copied.
//
// Bound on this card: operations.  At e_n = j_n = 8, T = 64 (the Table II
// matrix 5 column: bt + nat = 8 rows) the step is 64 general products,
// 2 T^3 each: 33.6 Mflop, 0.50 us at the fp32 rate, against 80 tiles read
// and written, 1.3 MB, 0.39 us at the memory rate.  e_n blocks of j_n
// dependent products on 132 SMs stay far from either.
#include "tile.cuh"

namespace stiles {

template <int T>
__global__ void __launch_bounds__(kThreads)
selinv_step_kernel(const float* __restrict__ s_row, const float* __restrict__ g_col,
                   float* __restrict__ u, int j_n) {
    __shared__ __align__(16) float As[T * Tile<T>::LDK];
    __shared__ __align__(16) float Bs[T * Tile<T>::LDK];
    constexpr size_t TT = static_cast<size_t>(T) * T;
    const size_t e = blockIdx.x;
    Acc<T> acc;
    zero_acc<T>(acc);
    gemm_sum<T>(acc, j_n, [&](int q) { return Op{s_row + (e * j_n + q) * TT, false}; },
                [&](int q) { return Op{g_col + static_cast<size_t>(q) * TT, false}; }, As, Bs);
    store_tile<T>(u + e * TT, acc);
}

}  // namespace stiles

// u[e] = sum_q s_row[e, q] g_col[q] for e < e_n (both e_n, j_n >= 1).
extern "C" int stiles_selinv_step_f32(const void* s_row, const void* g_col, void* u, int e_n,
                                      int j_n, int t, void* stream) {
    using namespace stiles;
    if (e_n < 1 || j_n < 1) return static_cast<int>(cudaErrorInvalidValue);
    const auto* ps = static_cast<const float*>(s_row);
    const auto* pg = static_cast<const float*>(g_col);
    auto* pu = static_cast<float*>(u);
    auto s = static_cast<cudaStream_t>(stream);
    switch (t) {
        case 8: selinv_step_kernel<8><<<e_n, kThreads, 0, s>>>(ps, pg, pu, j_n); break;
        case 16: selinv_step_kernel<16><<<e_n, kThreads, 0, s>>>(ps, pg, pu, j_n); break;
        case 32: selinv_step_kernel<32><<<e_n, kThreads, 0, s>>>(ps, pg, pu, j_n); break;
        case 64: selinv_step_kernel<64><<<e_n, kThreads, 0, s>>>(ps, pg, pu, j_n); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
