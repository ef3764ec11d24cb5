// Cholesky of a batch of SPD tiles: out[b] = L with a[b] = L L^T.
//
// Replaces the TPU kernel src/repro/kernels/potrf.py::potrf_pallas (body
// _potrf_kernel -> factorize_tile).
//
// Bound on this card: a tile is 2 T^2 floats moved for T^3 / 3 operations
// (32 KB and 87 kflop at T = 64), so the bytes bound it at a few ns, and
// neither bound is close: a factorization is a chain of dependent steps,
// so one tile's time is latency.  The first design ran a T-step column loop
// with two block barriers a column, 128 at T = 64.  This one is blocked,
// tile.cuh's factorize_smem (shared with the band-Cholesky sweep), so its
// barriers do not grow with T: the tile sits in shared memory, rows padded
// to T + 1 floats, and is walked in panels of 16 columns, one warp pass a
// panel and one trailing update over the block, 8 barriers at T = 64
// (load, two a panel for the first three panels, one for the last).  out
// may be a: the whole tile is read into shared memory before anything is
// written.  One block a tile of the batch.
#include "tile.cuh"

namespace stiles {

template <int T>
__host__ __device__ constexpr int potrf_threads() {
    return T == 64 ? 256 : T == 32 ? 128 : 32;
}

template <int T>
__global__ void __launch_bounds__(potrf_threads<T>())
potrf_kernel(const float* a, float* out) {  // out may be a: see above
    constexpr int NT = potrf_threads<T>();
    __shared__ float S[T * Panel<T>::LD];
    const size_t off = static_cast<size_t>(blockIdx.x) * T * T;
    stage_padded<T, NT>(S, a + off);
    __syncthreads();
    factorize_smem<T, NT>(S);
    store_lower<T, NT>(out + off, S);
}

template <int T>
cudaError_t launch_potrf(const float* a, float* out, int nb, cudaStream_t s) {
    potrf_kernel<T><<<nb, potrf_threads<T>(), 0, s>>>(a, out);
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
