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
// Grid (CL * NS^2, e_n) in clusters of CL along x (tile_sum.cuh, the plan
// from kernels/tile_sum.py): block (x, e) computes sub-tile x / CL (S x S,
// S = min(T, 32), NS = T / S per edge) of u[e] over cluster rank x % CL's
// contiguous run of `per` pairs q; rank 0 adds the ranks' partials in rank
// order through distributed shared memory and stores.  An NN product in
// plain FP32 FMAs (no TF32): s_row[e, q] and g_col[q] are staged as they
// are.  CL = min(j_n, 4).
//
// Bound on this card: operations.  At e_n = j_n = 8, T = 64 (the Table II
// matrix 5 column: bt + nat = 8 rows) the step is 64 general products,
// 2 T^3 each: 33.6 Mflop, 0.50 us at the fp32 rate, against 80 tiles read
// and written, 1.3 MB, 0.39 us at the memory rate.  The plan spreads it
// over 8 x 4 x 4 = 128 blocks, each 32 x 32 x 128 (two pairs), where the
// first design ran 8 blocks of eight chained 64 x 64 x 64 products.
#include "tile_sum.cuh"

namespace stiles {

template <int T>
__global__ void __launch_bounds__(kSumThreads)
selinv_step_kernel(const float* __restrict__ s_row, const float* __restrict__ g_col,
                   float* __restrict__ u, int j_n, int per) {
    constexpr size_t TT = static_cast<size_t>(T) * T;
    const size_t e = blockIdx.y;
    cluster_tile_sum<T, false>([&](int q) { return s_row + (e * j_n + q) * TT; },
                               [&](int q) { return g_col + static_cast<size_t>(q) * TT; },
                               j_n, per, u + e * TT);
}

template <int T>
cudaError_t launch_selinv_step(const float* s, const float* g, float* u, int e_n, int j_n,
                               int cl, int per, cudaStream_t stream) {
    constexpr int NS = SumShape<T>::NS;
    return launch_cluster(selinv_step_kernel<T>, dim3(cl * NS * NS, e_n), cl, 0, stream, s, g, u,
                          j_n, per);
}

}  // namespace stiles

// u[e] = sum_q s_row[e, q] g_col[q] for e < e_n (both e_n, j_n >= 1), on
// the plan (sub, cluster, per) of kernels/tile_sum.py::tile_sum_plan.
extern "C" int stiles_selinv_step_f32(const void* s_row, const void* g_col, void* u, int e_n,
                                      int j_n, int t, int sub, int cluster, int per,
                                      void* stream) {
    using namespace stiles;
    if (e_n < 1 || e_n > 65535 || j_n < 1 || !plan_ok(t, sub, cluster, per, j_n))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* ps = static_cast<const float*>(s_row);
    const auto* pg = static_cast<const float*>(g_col);
    auto* pu = static_cast<float*>(u);
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (t) {
        case 8: err = launch_selinv_step<8>(ps, pg, pu, e_n, j_n, cluster, per, s); break;
        case 16: err = launch_selinv_step<16>(ps, pg, pu, e_n, j_n, cluster, per, s); break;
        case 32: err = launch_selinv_step<32>(ps, pg, pu, e_n, j_n, cluster, per, s); break;
        case 64: err = launch_selinv_step<64>(ps, pg, pu, e_n, j_n, cluster, per, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
