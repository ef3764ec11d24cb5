// The band-panel update of the legacy window sweep: for a band window
// w (b+1, b+1, T, T) of the row-band factor, w[e, d] = L[k+e, k+e-d],
//   u[e] = sum_{j=1..b-e} w[e, e+j] w[0, j]^T        e = 0..b,
// every SYRK (e = 0) and GEMM (e > 0) accumulation that feeds panel k.
//
// Replaces the TPU kernel src/repro/kernels/band_update.py::band_update_pallas
// (body _band_update_kernel).  The TPU kernel gathers the shifted rows
// w[e, e+j] on the host side and walks b + 1 pairs a target tile, masking
// the ones past the band: b (b+1) products, half of them zero.  Here each
// block walks only its target's b - e structurally nonzero pairs,
// b (b+1) / 2 products in all, and reads the tiles where they are.
//
// Grid (b+1, B): block (e, i) accumulates u[e] of batch element i in plain
// FP32 FMAs (no TF32) through tile.cuh's gemm_nt_sum, the pairs j = 1..b-e
// in order, as the plain unrolled version (ref.band_update_unrolled_ref)
// sums them, so the two differ by rounding only.  Element i's window starts
// batch_stride floats after element i-1's and its (b+1) x (b+1) tiles are
// contiguous: a window sliced out of a batch of padded band rows,
// Drp[:, k:k+b+1], is read in place, with no gather copy per panel.
//
// Bound on this card: bytes.  At b = 4, T = 64 (Table II matrix 5) the
// update needs 10 tile products, 4 of them into the symmetric u[0]
// (T^3 each) and 6 general (2 T^3): 16 T^3 = 4.2 Mflop, 63 ns at the fp32
// rate; it reads the 10 tiles of its pairs and writes 5, 246 KB, 73 ns at
// the memory rate.  Neither is near: b + 1 blocks on 132 SMs, the longest
// a chain of b dependent staged products, so a launch costs its latency.
#include "tile.cuh"

namespace stiles {

template <int T>
__global__ void __launch_bounds__(kThreads)
band_update_kernel(const float* __restrict__ w, float* __restrict__ u, int b1,
                   long long batch_stride) {
    __shared__ __align__(16) float As[T * Tile<T>::LDK];
    __shared__ __align__(16) float Bs[T * Tile<T>::LDK];
    constexpr size_t TT = static_cast<size_t>(T) * T;
    const int e = blockIdx.x;
    const float* wb = w + blockIdx.y * batch_stride;
    Acc<T> acc;
    zero_acc<T>(acc);
    // pair q is j = q + 1 back: w[e, e + j] w[0, j]^T
    gemm_nt_sum<T>(acc, b1 - 1 - e,
                   [&](int q) { return wb + (static_cast<size_t>(e) * b1 + e + q + 1) * TT; },
                   [&](int q) { return wb + static_cast<size_t>(q + 1) * TT; }, As, Bs);
    store_tile<T>(u + (static_cast<size_t>(blockIdx.y) * b1 + e) * TT, acc);
}

}  // namespace stiles

// batch windows of (b1, b1, t, t) contiguous tiles, window i at
// w + i * batch_stride floats (a multiple of 4); u is (batch, b1, t, t).
extern "C" int stiles_band_update_f32(const void* w, void* u, int batch, int b1, int t,
                                      long long batch_stride, void* stream) {
    using namespace stiles;
    if (batch < 1 || batch > 65535 || b1 < 1) return static_cast<int>(cudaErrorInvalidValue);
    const auto* pw = static_cast<const float*>(w);
    auto* pu = static_cast<float*>(u);
    auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid(b1, batch);
    switch (t) {
        case 8: band_update_kernel<8><<<grid, kThreads, 0, s>>>(pw, pu, b1, batch_stride); break;
        case 16: band_update_kernel<16><<<grid, kThreads, 0, s>>>(pw, pu, b1, batch_stride); break;
        case 32: band_update_kernel<32><<<grid, kThreads, 0, s>>>(pw, pu, b1, batch_stride); break;
        case 64: band_update_kernel<64><<<grid, kThreads, 0, s>>>(pw, pu, b1, batch_stride); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
