// The task list's tile updates: GEMM and SYRK (out = C - A B^T, B = A for
// SYRK) over a batch of tiles, and GEADD (out = A + B), the combine of the
// Alg. 3 tree reduction.
//
// Replaces the TPU kernels src/repro/kernels/gemm.py::gemm_pallas (body
// _gemm_kernel), syrk_pallas (gemm_pallas with A = B, the full tile) and
// geadd_pallas (body _geadd_kernel).
//
// Bound on this card.  A GEMM tile is 2 T^3 operations on 4 T^2 floats
// moved (C, A, B in, the result out): at T = 64, 0.52 Mflop and 64 KB, so
// about 8 ns at the fp32 rate and 19 ns at the memory rate; a SYRK needs
// T^3 (its product is symmetric).  GEADD is 3 floats moved per add, bound
// by bytes.  One tile is far too little work to reach either bound: the
// factorization launches one kernel per task (about 7,000 on Table II
// matrix 5), so what a task costs is the launch and one block's latency.
// The design is the simplest that is right: one block per tile of the
// batch, A and B staged transposed in shared memory and the product in
// plain FP32 FMAs (no TF32) through tile.cuh's gemm_nt_sum, the owner
// layout's 4 x 4 accumulators a thread at T = 64; GEADD a grid-stride loop
// over float4s.
//
// A and B are a batch of tiles with a uniform stride each, 0 for one tile
// broadcast against every C.  out may be C itself (an in-place update):
// every element of C is read and then written by the same thread, and
// A and B are staged before any write.  A and B must not overlap out.
#include "tile.cuh"

namespace stiles {

template <int T>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* c, const float* a, const float* b, float* out, long long a_stride,
            long long b_stride) {
    __shared__ __align__(16) float As[T * Tile<T>::LDK];
    __shared__ __align__(16) float Bs[T * Tile<T>::LDK];
    const size_t off = static_cast<size_t>(blockIdx.x) * T * T;
    const float* ab = a + blockIdx.x * a_stride;
    const float* bb = b + blockIdx.x * b_stride;
    Acc<T> acc;
    zero_acc<T>(acc);
    gemm_nt_sum<T>(acc, 1, [&](int) { return ab; }, [&](int) { return bb; }, As, Bs);
    store_minus<T>(out + off, c + off, acc);
}

// out[i, j] = a[i, j] + b[i, j] over n4 float4s, an operand of the batch
// being `inner4` contiguous float4s at stride a_stride4 / b_stride4 (in
// float4s) from the one before; out is contiguous.
__global__ void __launch_bounds__(kThreads)
geadd_kernel(const float4* a, const float4* b, float4* out, long long n4, long long inner4,
             long long a_stride4, long long b_stride4) {
    for (long long v = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; v < n4;
         v += static_cast<long long>(gridDim.x) * kThreads) {
        const long long i = v / inner4, j = v % inner4;
        const float4 x = a[i * a_stride4 + j], y = b[i * b_stride4 + j];
        out[v] = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
    }
}

}  // namespace stiles

// nb tiles: out[q] = c[q] - a(q) b(q)^T, a(q) = a + q * a_stride floats,
// b(q) likewise.
extern "C" int stiles_gemm_f32(const void* c, const void* a, const void* b, void* out, int nb,
                               long long a_stride, long long b_stride, int t, void* stream) {
    using namespace stiles;
    const auto* pc = static_cast<const float*>(c);
    const auto* pa = static_cast<const float*>(a);
    const auto* pb = static_cast<const float*>(b);
    auto* po = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (t) {
        case 8: gemm_kernel<8><<<nb, kThreads, 0, s>>>(pc, pa, pb, po, a_stride, b_stride); break;
        case 16: gemm_kernel<16><<<nb, kThreads, 0, s>>>(pc, pa, pb, po, a_stride, b_stride); break;
        case 32: gemm_kernel<32><<<nb, kThreads, 0, s>>>(pc, pa, pb, po, a_stride, b_stride); break;
        case 64: gemm_kernel<64><<<nb, kThreads, 0, s>>>(pc, pa, pb, po, a_stride, b_stride); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// outer operands of `inner` floats each (a multiple of 4), at strides
// a_stride and b_stride floats (multiples of 4); out is contiguous.
extern "C" int stiles_geadd_f32(const void* a, const void* b, void* out, long long outer,
                                long long inner, long long a_stride, long long b_stride,
                                void* stream) {
    using namespace stiles;
    const long long n4 = outer * inner / 4;
    if (n4 == 0) return 0;
    const long long want = (n4 + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < 4096 ? want : 4096);
    geadd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(a), static_cast<const float4*>(b), static_cast<float4*>(out),
        n4, inner / 4, a_stride / 4, b_stride / 4);
    return static_cast<int>(cudaGetLastError());
}
