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
// by bytes.  Neither bound is near: the task list launches one tile at a
// time (about 5,600 gemm and syrk tasks on Table II matrix 5), so what a
// task costs is the launch and the latency of the blocks that compute the
// tile.  The first design gave a tile one block of 256 threads on one SM,
// which did all 262 k FMAs of a 64 x 64 x 64 product after staging A and B
// through registers into transposed shared memory (four scalar stores a
// float4), at about 27 FMA a cycle: some 5.3 us a tile.
//
// The design.  The output tile is split into (T / S)^2 pieces of S x S, a
// block each (the split: 1, 4, 16 or 64 blocks a tile, S >= 8), so a tile
// is spread over several SMs.  A piece reads only its S rows of A and of B;
// no sum crosses blocks, so there is no cluster reduction and no atomic.
// The block copies its rows straight into shared memory with 16-byte
// cp.async (no register round trip), row-major with rows padded to T + 4
// floats, in two groups (k < T / 2, then the rest) so the product of the
// first half starts while the second is in flight; C's elements are loaded
// into registers meanwhile.  Thread (ty, tx) holds the TR x TC outputs
// (ty + NTY r, tx + NTX s) of the piece and reads its rows of A and B as
// float4s along k: the lanes of a quarter warp read 8 rows of B at an odd
// float4 stride (distinct banks) and one row of A (a broadcast).  A block
// is 4 warps (pieces of 16 and 32) or 8 (64); the 8 x 8 piece is 2 warps,
// one output a thread.  Each output element's
// sum runs k = 0 .. T-1 in one thread, fmaf after fmaf from zero, then
// C minus it: every split gives the same bits.  The products are plain
// FP32 FMAs (no TF32: the reference computes float32 at HIGHEST, TF32
// keeps about 3 digits); 3xTF32 mma is the untried next step should the
// split product turn out bound by its operations.
//
// The default split (kernels/gemm.py::gemm_split) is the largest, pieces
// of 8 x 8 whatever the batch: at T = 64, 64 blocks a tile, which
// chip_smoke.py measured fastest on the task list's one tile and on a
// batch of five (PERF.md).  The task list, the only caller on the main
// path, launches one tile at a time; a batch-dependent choice waits for a
// caller that sends batches.  The task list replays its launches from a
// CUDA graph (core/cholesky.py), so the host's launch cost is gone from the
// caller's time as well.
//
// A and B are a batch of tiles with a uniform stride each, 0 for one tile
// broadcast against every C.  out may be C itself (an in-place update):
// every element of C is read and then written by the same thread.  A and
// B must not overlap out: another block may write its piece of out while
// this one still copies its rows.
//
// GEADD.  What an add of a few tiles costs is a launch and one round trip
// to memory; the first design (a grid-stride loop of one float4 a thread,
// up to 4,096 blocks) paid that and nothing else.  The grid is sized to the
// card: at most one block an SM, each thread with kAddInFlight float4 loads
// of each operand in flight before its first store.  The launch is a
// programmatic dependent launch (cudaLaunchKernelEx with programmatic
// stream serialization): the kernel may start while the one before it in
// the stream or graph is still finishing, so its launch overlaps that
// kernel's tail, and it waits at griddepcontrol.wait (what
// cudaGridDependencySynchronize compiles to) before its first load of A or
// B.  It lets the kernel after it launch at once (griddepcontrol.
// launch_dependents), which waits for this grid's end the same way.  The
// tree's levels (Alg. 3: 3 levels over 8 partials) are such a chain.  The
// kernel is the same with and without the attribute, so both give the same
// bits.
#include "tile_sum.cuh"

namespace stiles {

// A block's S x S piece of the output: thread (ty, tx) = (tid / NTX,
// tid % NTX) holds the TR x TC elements (ty + NTY r, tx + NTX s).
template <int S>
struct Piece {
    static constexpr int TR = S >= 64 ? 4 : (S >= 32 ? 2 : 1);   // rows a thread
    static constexpr int TC = S >= 32 ? 4 : (S >= 16 ? 2 : 1);   // columns a thread
    static constexpr int NTY = S / TR, NTX = S / TC;
    static constexpr int kThreads = NTY * NTX;
    static_assert(NTX >= 8, "a quarter warp must read distinct rows of B");
};

// Columns c0 .. c0 + W - 1 of the S rows of a row-major T x T tile at src,
// into dst (row stride T + 4), 16 bytes a copy; NT threads.
template <int T, int S, int W, int NT>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int c0) {
    constexpr int kC4 = W / 4, kVec = S * kC4;
#pragma unroll
    for (int p = 0; p < (kVec + NT - 1) / NT; ++p) {
        const int v = threadIdx.x + p * NT;
        if (kVec % NT == 0 || v < kVec) {
            const int r = v / kC4, c = c0 + 4 * (v % kC4);
            cp_async16(dst + r * (T + 4) + c, src + r * T + c);
        }
    }
}

// acc[r][s] += sum_{k0 <= k < k1} A[row r, k] B[col s, k], k in order.
template <int T, int S>
__device__ __forceinline__ void piece_product(float (&acc)[Piece<S>::TR][Piece<S>::TC],
                                              const float* As, const float* Bs, int ty, int tx,
                                              int k0, int k1) {
    using P = Piece<S>;
    constexpr int LD = T + 4;
#pragma unroll
    for (int k = k0; k < k1; k += 4) {
        float a[P::TR][4], b[P::TC][4];
#pragma unroll
        for (int r = 0; r < P::TR; ++r) ld_vec<4>(a[r], As + (ty + P::NTY * r) * LD + k);
#pragma unroll
        for (int s = 0; s < P::TC; ++s) ld_vec<4>(b[s], Bs + (tx + P::NTX * s) * LD + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < P::TR; ++r)
#pragma unroll
                for (int s = 0; s < P::TC; ++s) acc[r][s] = fmaf(a[r][kk], b[s][kk], acc[r][s]);
    }
}

// Block (q, piece): out[q] = c[q] - a(q) b(q)^T on the S x S piece
// blockIdx.y of tile blockIdx.x, a(q) = a + q * a_stride floats, b(q)
// likewise.
template <int T, int S>
__global__ void __launch_bounds__(Piece<S>::kThreads)
gemm_kernel(const float* c, const float* a, const float* b, float* out, long long a_stride,
            long long b_stride) {
    using P = Piece<S>;
    constexpr int H = T / 2;
    __shared__ __align__(16) float As[S * (T + 4)];
    __shared__ __align__(16) float Bs[S * (T + 4)];
    const int r0 = blockIdx.y / (T / S) * S, c0 = blockIdx.y % (T / S) * S;
    const float* ab = a + blockIdx.x * a_stride + static_cast<size_t>(r0) * T;
    const float* bb = b + blockIdx.x * b_stride + static_cast<size_t>(c0) * T;
    copy_rows<T, S, H, P::kThreads>(As, ab, 0);
    copy_rows<T, S, H, P::kThreads>(Bs, bb, 0);
    cp_async_commit();
    copy_rows<T, S, H, P::kThreads>(As, ab, H);
    copy_rows<T, S, H, P::kThreads>(Bs, bb, H);
    cp_async_commit();

    const int ty = threadIdx.x / P::NTX, tx = threadIdx.x % P::NTX;
    const size_t off = static_cast<size_t>(blockIdx.x) * T * T + static_cast<size_t>(r0) * T + c0;
    float cv[P::TR][P::TC], acc[P::TR][P::TC];
#pragma unroll
    for (int r = 0; r < P::TR; ++r)
#pragma unroll
        for (int s = 0; s < P::TC; ++s) {
            cv[r][s] = c[off + (ty + P::NTY * r) * T + tx + P::NTX * s];
            acc[r][s] = 0.f;
        }
    cp_async_wait<1>();
    __syncthreads();   // the first half of every row has landed
    piece_product<T, S>(acc, As, Bs, ty, tx, 0, H);
    cp_async_wait<0>();
    __syncthreads();
    piece_product<T, S>(acc, As, Bs, ty, tx, H, T);
#pragma unroll
    for (int r = 0; r < P::TR; ++r)
#pragma unroll
        for (int s = 0; s < P::TC; ++s)
            out[off + (ty + P::NTY * r) * T + tx + P::NTX * s] = cv[r][s] - acc[r][s];
}

template <int T, int S>
int launch_gemm(const float* c, const float* a, const float* b, float* out, int nb,
                long long a_stride, long long b_stride, cudaStream_t s) {
    gemm_kernel<T, S><<<dim3(nb, (T / S) * (T / S)), Piece<S>::kThreads, 0, s>>>(
        c, a, b, out, a_stride, b_stride);
    return static_cast<int>(cudaGetLastError());
}

template <int T>
int launch_gemm_t(int sub, const float* c, const float* a, const float* b, float* out, int nb,
                  long long a_stride, long long b_stride, cudaStream_t s) {
    switch (sub) {
        case 8: return launch_gemm<T, 8>(c, a, b, out, nb, a_stride, b_stride, s);
        case 16:
            if constexpr (T >= 16)
                return launch_gemm<T, 16>(c, a, b, out, nb, a_stride, b_stride, s);
            break;
        case 32:
            if constexpr (T >= 32)
                return launch_gemm<T, 32>(c, a, b, out, nb, a_stride, b_stride, s);
            break;
        case 64:
            if constexpr (T >= 64)
                return launch_gemm<T, 64>(c, a, b, out, nb, a_stride, b_stride, s);
            break;
        default: break;
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// griddepcontrol: wait for the kernel before this one in the stream to end
// (its writes visible), and let the kernel after this one launch now.  Both
// do nothing for a launch without the programmatic attribute.
__device__ __forceinline__ void grid_dependency_wait() {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

constexpr int kAddInFlight = 4;   // float4 loads of each operand a thread issues at once

// out[i, j] = a[i, j] + b[i, j] for `outer` operands i of `inner4`
// contiguous float4s j, operand i at a + i * a_stride4 (b likewise, in
// float4s); out is contiguous.  blockIdx.y walks the operands, blockIdx.x
// and the thread the float4s: no index is divided.
__global__ void __launch_bounds__(kThreads)
geadd_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
             float4* __restrict__ out, long long outer, long long inner4, long long a_stride4,
             long long b_stride4) {
    launch_dependents();
    grid_dependency_wait();
    const long long step = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = blockIdx.y; i < outer; i += gridDim.y) {
        const float4* ai = a + i * a_stride4;
        const float4* bi = b + i * b_stride4;
        float4* oi = out + i * inner4;
        for (long long j0 = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
             j0 < inner4; j0 += kAddInFlight * step) {
            float4 x[kAddInFlight], y[kAddInFlight];
#pragma unroll
            for (int p = 0; p < kAddInFlight; ++p) {
                const long long j = j0 + p * step;
                if (j < inner4) {
                    x[p] = ai[j];
                    y[p] = bi[j];
                }
            }
#pragma unroll
            for (int p = 0; p < kAddInFlight; ++p) {
                const long long j = j0 + p * step;
                if (j < inner4)
                    oi[j] = make_float4(x[p].x + y[p].x, x[p].y + y[p].y, x[p].z + y[p].z,
                                        x[p].w + y[p].w);
            }
        }
    }
}

// A kernel that does nothing, launched with geadd's grid: the floor of a
// one-tile launch, for measurement.
__global__ void __launch_bounds__(kThreads) empty_kernel() {
    launch_dependents();
    grid_dependency_wait();
}

// geadd's grid for `outer` operands of inner4 float4s on a card of `sms`
// SMs: at most one block an SM, the operands on y, each thread
// kAddInFlight float4s of an operand on x.
inline dim3 geadd_grid(long long outer, long long inner4, int sms) {
    const long long gy = outer < sms ? outer : sms;
    const long long want = (inner4 + kThreads * kAddInFlight - 1) / (kThreads * kAddInFlight);
    const long long room = sms / gy > 0 ? sms / gy : 1;
    return dim3(static_cast<unsigned>(want < room ? want : room), static_cast<unsigned>(gy));
}

// Launch `kernel` on `grid`, as a programmatic dependent launch where pdl
// is set.
template <typename... Args, typename... Act>
int launch_ex(void (*kernel)(Args...), dim3 grid, int pdl, cudaStream_t s, Act... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 1 : 0;
    const cudaError_t code = cudaLaunchKernelEx(&cfg, kernel, args...);
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(code != cudaSuccess ? code : last);
}

}  // namespace stiles

// nb tiles: out[q] = c[q] - a(q) b(q)^T, a(q) = a + q * a_stride floats,
// b(q) likewise, each tile in pieces of sub x sub, a block each
// (kernels/gemm.py::gemm_split; a piece size this file was not built for
// is refused).
extern "C" int stiles_gemm_f32(const void* c, const void* a, const void* b, void* out, int nb,
                               long long a_stride, long long b_stride, int t, int sub,
                               void* stream) {
    using namespace stiles;
    const auto* pc = static_cast<const float*>(c);
    const auto* pa = static_cast<const float*>(a);
    const auto* pb = static_cast<const float*>(b);
    auto* po = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (t) {
        case 8: return launch_gemm_t<8>(sub, pc, pa, pb, po, nb, a_stride, b_stride, s);
        case 16: return launch_gemm_t<16>(sub, pc, pa, pb, po, nb, a_stride, b_stride, s);
        case 32: return launch_gemm_t<32>(sub, pc, pa, pb, po, nb, a_stride, b_stride, s);
        case 64: return launch_gemm_t<64>(sub, pc, pa, pb, po, nb, a_stride, b_stride, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// outer operands of `inner` floats each (a multiple of 4), at strides
// a_stride and b_stride floats (multiples of 4); out is contiguous.  `sms`
// is the card's SM count; pdl makes it a programmatic dependent launch.
extern "C" int stiles_geadd_f32(const void* a, const void* b, void* out, long long outer,
                                long long inner, long long a_stride, long long b_stride,
                                int sms, int pdl, void* stream) {
    using namespace stiles;
    if (outer * inner == 0) return 0;
    return launch_ex(geadd_kernel, geadd_grid(outer, inner / 4, sms), pdl,
                     static_cast<cudaStream_t>(stream), static_cast<const float4*>(a),
                     static_cast<const float4*>(b), static_cast<float4*>(out), outer, inner / 4,
                     a_stride / 4, b_stride / 4);
}

// The empty kernel on the grid geadd takes for the same operands.
extern "C" int stiles_geadd_empty_f32(long long outer, long long inner, int sms, int pdl,
                                      void* stream) {
    using namespace stiles;
    if (outer * inner == 0) return 0;
    return launch_ex(empty_kernel, geadd_grid(outer, inner / 4, sms), pdl,
                     static_cast<cudaStream_t>(stream));
}

// The CUDA runtime's version (the toolkit this library was built with) and
// the driver's, as CUDA numbers them (12030 is 12.3).
extern "C" int stiles_cuda_versions(void* runtime, void* driver) {
    const cudaError_t code = cudaRuntimeGetVersion(static_cast<int*>(runtime));
    return static_cast<int>(code != cudaSuccess ? code
                                                : cudaDriverGetVersion(static_cast<int*>(driver)));
}
