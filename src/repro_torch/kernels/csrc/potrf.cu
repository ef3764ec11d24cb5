// Cholesky of a batch of SPD tiles: out[b] = L with a[b] = L L^T.
//
// Replaces the TPU kernel src/repro/kernels/potrf.py::potrf_pallas (body
// _potrf_kernel -> factorize_tile).
//
// Bound on this card: a tile is 2 T^2 floats moved for T^3 / 3 operations
// (32 KB and 87 kflop at T = 64), so the bytes bound it at a few ns, and
// neither bound is close: the T-step column loop is a chain of dependent
// steps, two block barriers each, so one tile's time is latency.  The
// design keeps the tile in registers across the whole loop (one block per
// tile, the owner layout of tile.cuh), touches device memory once in and
// once out, and runs the batch as independent blocks.  out may be a itself:
// an owner thread reads its elements before the column loop and writes them
// after it, and no other thread touches them.
#include "tile.cuh"

namespace stiles {

template <int T>
__global__ void __launch_bounds__(kThreads)
potrf_kernel(const float* a, float* out) {  // out may be a: see the wrapper
    __shared__ float colv[T + 1];
    const size_t off = static_cast<size_t>(blockIdx.x) * T * T;
    Acc<T> zero, tile;
    zero_acc<T>(zero);
    load_minus<T>(tile, a + off, zero);
    factorize_tile<T>(tile, colv);
    store_tile<T>(out + off, tile);
}

}  // namespace stiles

extern "C" int stiles_potrf_f32(const void* a, void* out, int nb, int t, void* stream) {
    using namespace stiles;
    const auto* pa = static_cast<const float*>(a);
    auto* po = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (t) {
        case 8: potrf_kernel<8><<<nb, kThreads, 0, s>>>(pa, po); break;
        case 16: potrf_kernel<16><<<nb, kThreads, 0, s>>>(pa, po); break;
        case 32: potrf_kernel<32><<<nb, kThreads, 0, s>>>(pa, po); break;
        case 64: potrf_kernel<64><<<nb, kThreads, 0, s>>>(pa, po); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
