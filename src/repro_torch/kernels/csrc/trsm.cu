// Off-diagonal tile solve for a batch of tiles: out[b] = a[b] L^{-T}, with
// one L for the whole batch, one L per tile, or one L per group of
// consecutive tiles (a batch of factorizations, each its own L over its
// panel).
//
// Replaces the TPU kernel src/repro/kernels/trsm.py::trsm_pallas (body
// _trsm_kernel -> substitute_right).
//
// Bound on this card: a tile is 3 T^2 floats moved (L, A, X) for T^3
// operations, so the bytes bound it; as for potrf, one tile is far too
// little work to reach either bound, and the T-long dependency chain of the
// substitution is what its time is made of.  The first design solved the
// rows a warp at a time through a T-step column loop of shuffle broadcasts.
// This one is blocked, tile.cuh's substitute_right (shared with the
// band-Cholesky sweep): each block stages its L (row stride T + 1) and the
// reciprocals of its diagonal in shared memory and the tile after them,
// then walks 16-column panels, each a row-independent solve of the diagonal
// block (a thread a row, L read as broadcasts) and one trailing update over
// the whole block: 8 block barriers at T = 64.  out may be a itself (an
// in-place solve): the tile is read whole into shared memory before any of
// it is written; out must not overlap l.
#include "tile.cuh"

namespace stiles {

template <int T>
__global__ void __launch_bounds__(kThreads)
trsm_kernel(const float* __restrict__ l, const float* a, float* out, int l_group) {
    constexpr int LD = Panel<T>::LD;
    __shared__ float L[T * LD];
    __shared__ float dinv[T];
    __shared__ float X[(T < kSubChunk ? T : kSubChunk) * LD];
    const float* lb = l + (l_group ? static_cast<size_t>(blockIdx.x / l_group) * T * T : 0);
    stage_padded<T, kThreads>(L, lb);
    __syncthreads();
    store_pivots<T, kThreads>(dinv, L);
    const float* ab = a + static_cast<size_t>(blockIdx.x) * T * T;
    float* ob = out + static_cast<size_t>(blockIdx.x) * T * T;
    substitute_right<T, kThreads>(X, L, dinv, T, [&](int r) { return ab + r * T; },
                                  [&](int r) { return ob + r * T; });
}

}  // namespace stiles

// l_group = 0: l is one (t, t) tile for every a[b]; g >= 1: a[b] is solved
// against l[b / g], l being (nb / g, t, t) (g = 1: one L per tile).
extern "C" int stiles_trsm_f32(const void* l, const void* a, void* out, int nb, int t,
                               int l_group, void* stream) {
    using namespace stiles;
    const auto* pl = static_cast<const float*>(l);
    const auto* pa = static_cast<const float*>(a);
    auto* po = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (t) {
        case 8: trsm_kernel<8><<<nb, kThreads, 0, s>>>(pl, pa, po, l_group); break;
        case 16: trsm_kernel<16><<<nb, kThreads, 0, s>>>(pl, pa, po, l_group); break;
        case 32: trsm_kernel<32><<<nb, kThreads, 0, s>>>(pl, pa, po, l_group); break;
        case 64: trsm_kernel<64><<<nb, kThreads, 0, s>>>(pl, pa, po, l_group); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
