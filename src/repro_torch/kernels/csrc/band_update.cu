// The band-panel update of the legacy window sweep: for a band window
// w (b+1, b+1, T, T) of the row-band factor, w[e, d] = L[k+e, k+e-d],
//   u[e] = sum_{j=1..b-e} w[e, e+j] w[0, j]^T        e = 0..b,
// every SYRK (e = 0) and GEMM (e > 0) accumulation that feeds panel k.
//
// Replaces the TPU kernel src/repro/kernels/band_update.py::band_update_pallas
// (body _band_update_kernel).  The TPU kernel gathers the shifted rows
// w[e, e+j] on the host side and walks b + 1 pairs a target tile, masking
// the ones past the band: b (b+1) products, half of them zero.  Here only
// a target's b - e structurally nonzero pairs are walked, b (b+1) / 2
// products in all, and the tiles are read where they are.
//
// Grid (CL * NS^2, b+1, B) in clusters of CL along x (tile_sum.cuh, the
// plan from kernels/tile_sum.py): block (x, e, i) computes sub-tile x / CL
// (S x S, S = min(T, 32), NS = T / S per edge) of u[e] of batch element i
// over cluster rank x % CL's contiguous run of `per` pairs j; rank 0 adds
// the ranks' partials in rank order through distributed shared memory and
// stores.  An NT product in plain FP32 FMAs (no TF32), both operands staged
// as they are.  CL = min(b, 4); target e = b has no pairs and is written
// as zeros, and a rank past a target's b - e pairs adds a zero partial.
// Element i's window starts batch_stride floats after element i-1's and
// its (b+1) x (b+1) tiles are contiguous: a window sliced out of a batch of
// padded band rows, Drp[:, k:k+b+1], is read in place, with no gather copy
// per panel; its bits are those of its unbatched launch.
//
// Bound on this card: bytes.  At b = 4, T = 64 (Table II matrix 5) the
// update needs 10 tile products, 4 of them into the symmetric u[0]
// (T^3 each) and 6 general (2 T^3): 16 T^3 = 4.2 Mflop, 63 ns at the fp32
// rate; it reads the 10 tiles of its pairs and writes 5, 246 KB, 73 ns at
// the memory rate.  The plan launches 5 x 4 x 4 = 80 blocks, 40 of them
// with a pair (one each), where the first design ran 5 blocks, the longest
// a chain of 4 staged products; a launch still costs mostly its latency.
#include "tile_sum.cuh"

namespace stiles {

template <int T>
__global__ void __launch_bounds__(kSumThreads)
band_update_kernel(const float* __restrict__ w, float* __restrict__ u, int b1,
                   long long batch_stride, int per) {
    constexpr size_t TT = static_cast<size_t>(T) * T;
    const int e = blockIdx.y;
    const float* wb = w + blockIdx.z * batch_stride;
    // pair q is j = q + 1 back: w[e, e + j] w[0, j]^T
    cluster_tile_sum<T, true>(
        [&](int q) { return wb + (static_cast<size_t>(e) * b1 + e + q + 1) * TT; },
        [&](int q) { return wb + static_cast<size_t>(q + 1) * TT; }, b1 - 1 - e, per,
        u + (static_cast<size_t>(blockIdx.z) * b1 + e) * TT);
}

template <int T>
cudaError_t launch_band_update(const float* w, float* u, int batch, int b1,
                               long long batch_stride, int cl, int per, cudaStream_t stream) {
    constexpr int NS = SumShape<T>::NS;
    return launch_cluster(band_update_kernel<T>, dim3(cl * NS * NS, b1, batch), cl, 0, stream, w,
                          u, b1, batch_stride, per);
}

}  // namespace stiles

// batch windows of (b1, b1, t, t) contiguous tiles, window i at
// w + i * batch_stride floats (a multiple of 4); u is (batch, b1, t, t);
// the plan (sub, cluster, per) of kernels/tile_sum.py::tile_sum_plan.
extern "C" int stiles_band_update_f32(const void* w, void* u, int batch, int b1, int t,
                                      long long batch_stride, int sub, int cluster, int per,
                                      void* stream) {
    using namespace stiles;
    if (batch < 1 || batch > 65535 || b1 < 1 || b1 > 65535 ||
        !plan_ok(t, sub, cluster, per, b1 - 1))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* pw = static_cast<const float*>(w);
    auto* pu = static_cast<float*>(u);
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (t) {
        case 8: err = launch_band_update<8>(pw, pu, batch, b1, batch_stride, cluster, per, s); break;
        case 16: err = launch_band_update<16>(pw, pu, batch, b1, batch_stride, cluster, per, s); break;
        case 32: err = launch_band_update<32>(pw, pu, batch, b1, batch_stride, cluster, per, s); break;
        case 64: err = launch_band_update<64>(pw, pu, batch, b1, batch_stride, cluster, per, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
